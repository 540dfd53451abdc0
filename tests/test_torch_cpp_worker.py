"""The port's C++ worker API (``ray_tpu_torch/_native/cpp_worker.cc`` on the
hand-written proto3 codec ``pbwire.h``) against the JAX package's.

(a) The codec against ``ray_tpu_torch.protocol.pb``: its field table
against the descriptor, and a harness compiled with g++ (under ASan and
UBSan) that parses and re-serialises what Python serialises, every field
set, ``inline`` packed and unpacked, unknown fields kept; truncated and
malformed buffers throw, as Python's parser refuses them. (b) The
reference's scenarios (``tests/test_cpp_worker.py``) with the port's binary
against a port ``ProcessCluster``. (c) The JAX package's binary and the
port's print the same lines against one port cluster, and the port's binary
drives a JAX package cluster. (d) A 2-layer transformer in a port daemon,
called through the port's binary, against ``ray_tpu.models.transformer``.
(e) The binary links no ``libprotobuf``.

Test daemons never see a card (``CUDA_VISIBLE_DEVICES=""``).
"""

import json
import os
import subprocess
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu.cluster_utils
import ray_tpu_torch
import ray_tpu_torch.cluster_utils
from ray_tpu_torch._native import build as port_build
from ray_tpu_torch.protocol import pb

NATIVE = os.path.dirname(os.path.abspath(port_build.__file__))
MESSAGES = ("Envelope", "Resources", "NodeInfo", "ListNodesReply",
            "KvPutRequest", "KvPutReply", "KvGetRequest", "KvGetReply",
            "TaskSpecMsg", "PushTaskReply")
METHODS = ("LIST_NODES", "KV_PUT", "KV_GET", "PUSH_TASK", "AUTH")

HARNESS = r"""
#include <cstdio>
#include <functional>
#include <map>
#include <string>
#include <vector>

#include "pbwire.h"

using Roundtrip = std::function<std::string(const std::string&)>;

template <typename M>
Roundtrip Of() {
  return [](const std::string& b) { return M::Parse(b).Serialize(); };
}

// Parses [p, p + n) from a buffer of exactly n bytes, so that ASan sees any
// read past it.
template <typename M>
bool ParsesExactly(const char* data, size_t n) {
  std::vector<char> heap(data, data + n);
  const char* p = heap.empty() ? nullptr : heap.data();
  M m;
  pbwire::detail::Reader r(p, p + n);
  try {
    pbwire::detail::MergeMessage(m, r);
  } catch (const pbwire::ParseError&) {
    return false;
  }
  return true;
}

int main(int argc, char** argv) {
  std::string mode = argv[1];
  if (mode == "table") {
    for (const auto& f : pbwire::FieldTable())
      printf("%s\t%s\t%d\t%d\t%s\n", f.message.c_str(), f.field.c_str(),
             f.number, f.wire_type, f.type.c_str());
    for (const auto& m : pbwire::MethodTable())
      printf("method\t%s\t%u\n", m.name, m.number);
    return 0;
  }
  std::string in;
  char buf[65536];
  size_t got;
  while ((got = fread(buf, 1, sizeof(buf), stdin)) > 0) in.append(buf, got);
  std::string message = argv[2];
  if (mode == "prefixes") {  // one line: '1' if prefix i parses, else '0'
    std::map<std::string, std::function<bool(const char*, size_t)>> parse = {
        {"TaskSpecMsg", ParsesExactly<pbwire::TaskSpecMsg>},
        {"PushTaskReply", ParsesExactly<pbwire::PushTaskReply>},
        {"ListNodesReply", ParsesExactly<pbwire::ListNodesReply>},
        {"Envelope", ParsesExactly<pbwire::Envelope>}};
    for (size_t i = 0; i <= in.size(); ++i)
      putchar(parse.at(message)(in.data(), i) ? '1' : '0');
    putchar('\n');
    return 0;
  }
  std::map<std::string, Roundtrip> roundtrip = {
      {"Envelope", Of<pbwire::Envelope>()},
      {"Resources", Of<pbwire::Resources>()},
      {"NodeInfo", Of<pbwire::NodeInfo>()},
      {"ListNodesReply", Of<pbwire::ListNodesReply>()},
      {"KvPutRequest", Of<pbwire::KvPutRequest>()},
      {"KvPutReply", Of<pbwire::KvPutReply>()},
      {"KvGetRequest", Of<pbwire::KvGetRequest>()},
      {"KvGetReply", Of<pbwire::KvGetReply>()},
      {"TaskSpecMsg", Of<pbwire::TaskSpecMsg>()},
      {"PushTaskReply", Of<pbwire::PushTaskReply>()}};
  try {
    std::string out = roundtrip.at(message)(in);
    fwrite(out.data(), 1, out.size(), stdout);
  } catch (const pbwire::ParseError& e) {
    fprintf(stderr, "ParseError: %s\n", e.what());
    return 3;
  }
  return 0;
}
"""


# -- builds ------------------------------------------------------------------


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    """(the port's demo binary, the codec harness), built at once."""
    src = tmp_path_factory.mktemp("harness") / "harness.cc"
    src.write_text(HARNESS)
    out = {}

    def demo():
        out["demo"] = port_build.build_cpp_worker_demo()

    def harness():
        exe = str(src.with_suffix(""))
        subprocess.run(["g++", "-O0", "-std=c++17",
                        "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=all", f"-I{NATIVE}", "-o", exe,
                        str(src)], check=True, capture_output=True, text=True,
                       timeout=120)
        out["harness"] = exe

    threads = [threading.Thread(target=f) for f in (demo, harness)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert set(out) == {"demo", "harness"}, "a build failed"
    return out


@pytest.fixture(scope="module")
def demo_bin(binaries):
    return binaries["demo"]


def _harness(binaries, *args, data=b""):
    return subprocess.run([binaries["harness"], *args], input=data,
                          capture_output=True, timeout=60)


# -- (a) the codec -----------------------------------------------------------

_SCALAR_TYPES = {
    "TYPE_UINT64": ("uint64", 0), "TYPE_UINT32": ("uint32", 0),
    "TYPE_INT32": ("int32", 0), "TYPE_BOOL": ("bool", 0),
    "TYPE_DOUBLE": ("double", 1), "TYPE_STRING": ("string", 2),
    "TYPE_BYTES": ("bytes", 2)}


def _type_name(f):
    return next(k for k, v in vars(type(f)).items()
                if k.startswith("TYPE_") and v == f.type)


def _is_map(f):
    return f.message_type is not None and f.message_type.GetOptions().map_entry


def _repeated(f):
    repeated = getattr(f, "is_repeated", None)   # protobuf >= 5.29
    return f.label == f.LABEL_REPEATED if repeated is None else repeated


def _descriptor_row(f):
    """(number, wire type, type) as raytpu.proto spells the field."""
    if _is_map(f):
        key, value = (f.message_type.fields_by_name[n] for n in ("key",
                                                                "value"))
        return (f.number, 2, f"map<{_SCALAR_TYPES[_type_name(key)][0]}, "
                             f"{_SCALAR_TYPES[_type_name(value)][0]}>")
    if f.message_type is not None:
        name = f.message_type.name
        return f.number, 2, f"repeated {name}" if _repeated(f) else name
    name, wire = _SCALAR_TYPES[_type_name(f)]
    if _repeated(f):   # proto3 packs repeated scalars; bytes stay delimited
        return f.number, 2, f"repeated {name}"
    return f.number, wire, name


def test_field_table_matches_descriptor(binaries):
    out = _harness(binaries, "table")
    assert out.returncode == 0, out.stderr
    rows = [line.split("\t") for line in out.stdout.decode().splitlines()]
    table = {}
    for row in rows:
        if row[0] == "method":
            assert pb.Method.Value(row[1]) == int(row[2]), row
            continue
        table.setdefault(row[0], {})[row[1]] = (int(row[2]), int(row[3]),
                                                row[4])
    assert sorted(r[1] for r in rows if r[0] == "method") == sorted(METHODS)
    assert set(table) == set(MESSAGES)
    for name, fields in table.items():
        desc = getattr(pb, name).DESCRIPTOR
        want = {f.name: _descriptor_row(f) for f in desc.fields}
        assert fields == want, name


_SCALARS = {
    "TYPE_UINT64": [2**64 - 1, 1, 300], "TYPE_UINT32": [2**32 - 1, 1, 128],
    "TYPE_INT32": [-7, -(2**31), 2**31 - 1], "TYPE_BOOL": [True, False, True],
    "TYPE_DOUBLE": [-1.25e-300, 0.0, 3.5e300],
    "TYPE_STRING": ["héllo\n☃", "", "x" * 200],
    "TYPE_BYTES": [b"\x00\xff\x80raw", b"", bytes(range(256)) * 2]}


def _filled(cls):
    """A ``cls`` with every field set: maps and repeated fields with three
    entries (defaults among them), submessages filled in turn."""
    m = cls()
    for f in cls.DESCRIPTOR.fields:
        if _is_map(f):
            value = f.message_type.fields_by_name["value"]
            for i, v in enumerate(_SCALARS[_type_name(value)]):
                getattr(m, f.name)[f"key{i}"] = v
        elif f.message_type is not None:
            sub = getattr(pb, f.message_type.name)
            if _repeated(f):
                for _ in range(2):
                    getattr(m, f.name).add().CopyFrom(_filled(sub))
            else:
                getattr(m, f.name).CopyFrom(_filled(sub))
        elif _repeated(f):
            getattr(m, f.name).extend(_SCALARS[_type_name(f)])
        else:
            setattr(m, f.name, _SCALARS[_type_name(f)][0])
    return m


def _varint(v):
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _tag(number, wire_type):
    return _varint(number << 3 | wire_type)


# fields no message of the schema has, one per wire type and a group with a
# nested one, and field 1 on a wire type it is not declared with
UNKNOWN = (_tag(1000, 0) + _varint(2**63 + 5) + _tag(1001, 1) + bytes(8)
           + _tag(1002, 2) + _varint(3) + b"xyz" + _tag(1003, 5)
           + b"\x01\x02\x03\x04" + _tag(1004, 3) + _tag(1, 0) + b"\x05"
           + _tag(7, 3) + _tag(7, 4) + _tag(1004, 4)
           + _tag(1, 5) + b"\x09\x08\x07\x06")


def _roundtrip(binaries, name, data):
    out = _harness(binaries, "roundtrip", name, data=data)
    assert out.returncode == 0, out.stderr.decode()
    return out.stdout


@pytest.mark.parametrize("name", MESSAGES)
def test_codec_roundtrips_every_field(binaries, name):
    cls = getattr(pb, name)
    want = _filled(cls)
    data = want.SerializeToString(deterministic=True)
    got = _roundtrip(binaries, name, data)
    # the same bytes as Python's deterministic (map keys sorted) output
    assert got == data
    assert cls.FromString(got) == want
    # fields the codec does not know come back as they went
    with_unknown = cls.FromString(data + UNKNOWN)
    assert cls.FromString(_roundtrip(binaries, name, data + UNKNOWN)) \
        == with_unknown


@pytest.mark.parametrize("message", [
    pb.TaskSpecMsg(pg_bundle_index=-1, num_returns=1),
    pb.NodeInfo(last_heartbeat_ms=-0.0, alive=True),
    pb.NodeInfo(total=pb.Resources()),     # an empty submessage is present
    pb.Envelope(seq=2**64 - 1, method=pb.AUTH),
    pb.PushTaskReply(), pb.Resources(amounts={"": 0.0})],
    ids=["negative-int32", "negative-zero", "empty-submessage", "envelope",
         "empty", "default-map-entry"])
def test_codec_edge_values(binaries, message):
    name = type(message).DESCRIPTOR.name
    data = message.SerializeToString(deterministic=True)
    got = _roundtrip(binaries, name, data)
    assert got == data
    assert type(message).FromString(got) == message
    if name == "TaskSpecMsg":   # int32 -1 is a 10-byte varint
        assert _tag(16, 0) + b"\xff" * 9 + b"\x01" in got


def test_inline_unpacked_and_packed(binaries):
    """Python packs ``repeated bool inline``; an unpacked buffer (and one
    mixing both) parses to the same list, re-serialised packed."""
    packed = pb.PushTaskReply(status="ok", inline=[True, False, True],
                              inline_results=[b"1", b"", b"[2]"])
    data = packed.SerializeToString()
    assert _tag(4, 2) in data     # Python's own form is packed
    unpacked = (_tag(1, 2) + b"\x02ok"
                + b"".join(_tag(3, 2) + _varint(len(r)) + r
                           for r in (b"1", b"", b"[2]"))
                + _tag(4, 0) + b"\x01" + _tag(4, 0) + b"\x00"
                + _tag(4, 0) + b"\x01")
    assert pb.PushTaskReply.FromString(unpacked) == packed
    mixed = (_tag(1, 2) + b"\x02ok" + _tag(4, 0) + b"\x01"
             + _tag(4, 2) + b"\x02\x00\x01"
             + b"".join(_tag(3, 2) + _varint(len(r)) + r
                        for r in (b"1", b"", b"[2]")))
    for buf in (data, unpacked, mixed):
        got = _roundtrip(binaries, "PushTaskReply", buf)
        assert got == data, buf
        assert pb.PushTaskReply.FromString(got) == packed


def _python_parses(cls, data):
    try:
        cls.FromString(data)
    except Exception:  # raylint: allow(swallow) DecodeError is the answer
        return False
    return True


@pytest.mark.parametrize("name", ["TaskSpecMsg", "PushTaskReply",
                                  "ListNodesReply", "Envelope"])
def test_truncated_buffers_throw(binaries, name):
    """Every prefix of a filled message: the harness parses it exactly when
    Python does, and the whole message parses; under ASan, so no read
    passes the prefix's end."""
    cls = getattr(pb, name)
    data = _filled(cls).SerializeToString() + UNKNOWN
    out = _harness(binaries, "prefixes", name, data=data)
    assert out.returncode == 0, out.stderr.decode()[-3000:]
    got = out.stdout.decode().strip()
    want = "".join("1" if _python_parses(cls, data[:i]) else "0"
                   for i in range(len(data) + 1))
    assert got == want
    assert got[-1] == "1" and got.count("0") > len(data) // 2


@pytest.mark.parametrize("data", [
    b"\x08" + b"\xff" * 10 + b"\x01",     # varint longer than 10 bytes
    b"\x2a\x05ab",                        # body longer than the buffer
    b"\x2a" + b"\xff" * 9 + b"\x01",      # a huge declared length
    b"\x00\x01",                          # field number 0
    b"\x0b\x08\x01",                      # a group never closed
    b"\x0b\x08\x01\x14",                  # closed as another group
    b"\x0c",                              # an end tag without a group
    b"\x0e\x01",                          # wire type 6
    b"\x09\x01\x02",                      # fixed64 cut short
    b"\x0d\x01"],                         # fixed32 cut short
    ids=["long-varint", "short-body", "huge-length", "field-zero",
         "open-group", "mismatched-group", "stray-end-group", "wire-type-6",
         "short-fixed64", "short-fixed32"])
def test_malformed_buffers_throw(binaries, data):
    assert not _python_parses(pb.Envelope, data)
    out = _harness(binaries, "roundtrip", "Envelope", data=data)
    assert out.returncode == 3, (out.returncode, out.stderr.decode()[-2000:])
    assert b"ParseError" in out.stderr


# -- (b) the reference's scenarios on a port cluster -------------------------


@pytest.fixture(scope="module")
def clusters():
    """One port and one JAX package ``ProcessCluster(num_daemons=2,
    num_cpus=2)``, started at once; the JAX package's driver joins its own
    (the port's joins through ``cluster``)."""
    for pkg in (ray_tpu, ray_tpu_torch):
        pkg.shutdown()
    made = {}

    def start(name, pkg):
        made[name] = pkg.cluster_utils.ProcessCluster(num_daemons=2,
                                                      num_cpus=2)

    threads = [threading.Thread(target=start, args=a)
               for a in (("torch", ray_tpu_torch), ("jax", ray_tpu))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    try:
        assert set(made) == {"torch", "jax"}, "a cluster failed to start"
        ray_tpu.init(address=made["jax"].address)
        yield made
    finally:
        for pkg in (ray_tpu, ray_tpu_torch):
            pkg.shutdown()
        for c in made.values():
            c.shutdown()


@pytest.fixture()
def cluster(clusters):
    """The port cluster, with this process's port driver joined to it."""
    c = clusters["torch"]
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(address=c.address)
    return c


def _run(args, timeout=60):
    return subprocess.run(args, capture_output=True, text=True,
                          timeout=timeout)


def test_cpp_driver_end_to_end(cluster, demo_bin):
    @ray_tpu_torch.register_named_function("cpp_add")
    def add(a, b):
        return a + b

    proc = _run([demo_bin, cluster.address])
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "nodes=3" in out or "nodes=2" in out, out  # 2 daemons (+driver)
    assert "kv=from-cpp" in out
    assert "cpp_add(2,3)=5" in out, out
    assert ray_tpu_torch._private.worker.global_worker().runtime.state.kv_get(
        b"cpp-kv-key") == b"from-cpp"


def test_cpp_driver_task_error_is_language_neutral(cluster, demo_bin):
    @ray_tpu_torch.register_named_function("cpp_add")
    def bad(a, b):
        raise ValueError("deliberate")

    proc = _run([demo_bin, cluster.address])
    assert proc.returncode == 1
    assert "deliberate" in proc.stderr  # error_message, not a pickle


def test_named_function_from_python_side(cluster):
    """Named functions are callable from Python too (registry + JSON)."""
    rt = ray_tpu_torch._private.worker.global_worker().runtime

    @ray_tpu_torch.register_named_function("sq")
    def sq(x):
        return x * x

    fn = rt._load_named_function("sq")
    assert fn(7) == 49
    with pytest.raises(ray_tpu_torch.exceptions.RayTpuError):
        rt._load_named_function("nope")


def test_cpp_driver_with_auth(cluster, demo_bin, monkeypatch):
    ray_tpu_torch.shutdown()
    monkeypatch.setenv("RAY_TPU_AUTH_TOKEN", "cpp-secret")
    c = ray_tpu_torch.cluster_utils.ProcessCluster(num_daemons=1, num_cpus=2)
    try:
        ray_tpu_torch.init(address=c.address)

        @ray_tpu_torch.register_named_function("cpp_add")
        def add(a, b):
            return a * 10 + b

        ok = _run([demo_bin, c.address, "cpp-secret"])
        assert ok.returncode == 0, ok.stderr
        assert "cpp_add(2,3)=23" in ok.stdout
        # wrong token: rejected at the wire, no result
        bad = _run([demo_bin, c.address, "wrong"])
        assert bad.returncode != 0
        assert "cpp_add" not in bad.stdout
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()


def _register_typed(pkg):
    @pkg.register_named_function("cpp_add")
    def add(a, b):
        return a + b

    @pkg.register_named_actor_class("Counter")
    class Counter:
        def __init__(self, start):
            self.v = start

        def add(self, x):
            self.v += x
            return self.v

        def total(self):
            return self.v


def test_cpp_typed_task_and_actor_api(cluster, demo_bin):
    """The typed C++ surface: Task(...).Remote<int64_t>() -> ObjectRef
    Get(), Actor(...).Remote() -> typed method calls -> Kill()."""
    _register_typed(ray_tpu_torch)
    proc = _run([demo_bin, cluster.address, "--typed"], timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "typed_add=5" in out, out
    assert "counter_add=15" in out, out
    assert "counter_add2=22" in out, out
    assert "counter_total=22" in out, out
    assert "typed-ok" in out, out
    # Kill() took effect: the named actor is gone from Python's view too
    actor_name = next(line.split("=", 1)[1] for line in out.splitlines()
                      if line.startswith("actor_name="))
    deadline = time.monotonic() + 15
    gone = False
    while time.monotonic() < deadline and not gone:
        try:
            h = ray_tpu_torch.get_actor(actor_name)
            ray_tpu_torch.get(h.total.remote(), timeout=5)
            time.sleep(0.2)  # raylint: allow(bare-retry) deadline-bounded test poll
        except Exception:  # raylint: allow(swallow) any failure means the actor is gone (the pass condition)
            gone = True
    assert gone, f"actor {actor_name} still alive after Kill()"


def test_named_actor_class_from_python(cluster):
    """The named actor class protocol is language-neutral: the same three
    named functions drive it from Python."""
    rt = ray_tpu_torch._private.worker.global_worker().runtime

    @ray_tpu_torch.register_named_actor_class("Acc")
    class Acc:
        def __init__(self, base):
            self.v = base

        def bump(self, n):
            self.v += n
            return self.v

    new = rt._load_named_function("__actor_new__::Acc")
    assert new("acc-py-1", 100) == "acc-py-1"
    call = rt._load_named_function("__actor_call__")
    assert call("acc-py-1", "bump", 11) == 111
    assert call("acc-py-1", "bump", 1) == 112
    kill = rt._load_named_function("__actor_kill__")
    assert kill("acc-py-1") is True


# -- (c) interop with the JAX package ----------------------------------------


@pytest.fixture(scope="module")
def jax_demo_bin():
    from ray_tpu._native.build import NativeBuildError, build_cpp_worker_demo
    try:
        return build_cpp_worker_demo()
    except NativeBuildError as e:
        pytest.skip(f"the JAX package's cpp worker demo is unbuildable: {e}")


@pytest.mark.parametrize("typed", [False, True], ids=["plain", "typed"])
def test_jax_and_port_binaries_print_the_same_lines(cluster, demo_bin,
                                                    jax_demo_bin, typed):
    _register_typed(ray_tpu_torch)
    lines = []
    for exe in (jax_demo_bin, demo_bin):
        proc = _run([exe, cluster.address] + (["--typed"] if typed else []),
                    timeout=120)
        assert proc.returncode == 0, (exe, proc.stderr)
        lines.append([ln.split("=")[0] if ln.startswith("actor_name=")
                      else ln for ln in proc.stdout.splitlines()])
    assert lines[0] == lines[1]
    assert ("typed-ok" if typed else "cpp_add(2,3)=5") in lines[1]


def test_port_binary_against_jax_cluster(clusters, demo_bin):
    """The JAX package's cluster (its C++ state service and daemons) serves
    the port's binary."""
    @ray_tpu.register_named_function("cpp_add")
    def add(a, b):
        return a + b

    proc = _run([demo_bin, clusters["jax"].address])
    assert proc.returncode == 0, proc.stderr
    assert "nodes=3" in proc.stdout or "nodes=2" in proc.stdout, proc.stdout
    assert "kv=from-cpp" in proc.stdout
    assert "cpp_add(2,3)=5" in proc.stdout, proc.stdout


# -- (d) the slice against JAX -----------------------------------------------


def test_cpp_driven_transformer_matches_jax(cluster, demo_bin):
    """``cpp_add(2, 3)`` from the port's binary runs a 2-layer, narrow
    transformer in a port daemon on 3 tokens from numpy's seed 2; its
    last-position logits, returned as JSON, equal the JAX forward's at
    ``tests/test_torch_models.py``'s tolerance, and so does the argmax."""
    import jax
    import jax.numpy as jnp
    import torch

    from ray_tpu.models import transformer as jax_transformer
    from ray_tpu_torch.models.transformer import TransformerConfig

    tiny = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                max_seq_len=128, use_flash=True)
    jcfg = jax_transformer.TransformerConfig(**tiny, dtype=jnp.float32)
    cfg = TransformerConfig(**tiny, dtype=torch.float32)
    np_params = jax.tree.map(np.asarray, jax_transformer.init_params(
        jax.random.PRNGKey(0), jcfg))

    def seeded_tokens(seed, n_tokens):
        return np.random.default_rng(seed).integers(
            0, tiny["vocab_size"], size=(1, n_tokens), dtype=np.int32)

    @ray_tpu_torch.register_named_function("cpp_add")
    def last_logits(seed, n_tokens):
        import os

        import torch as t

        from ray_tpu_torch.models import transformer
        params = transformer.params_from_numpy(np_params, cfg, "cpu")
        tokens = t.tensor(seeded_tokens(seed, n_tokens))
        with t.inference_mode():
            row = transformer.apply(params, tokens, cfg)[0, -1]
        return {"pid": os.getpid(), "logits": row.tolist()}

    proc = _run([demo_bin, cluster.address], timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("cpp_add(2,3)="))
    got = json.loads(line.split("=", 1)[1])
    assert got["pid"] != os.getpid()   # it ran in a daemon
    want = np.asarray(jax_transformer.apply(
        jax.tree.map(jnp.asarray, np_params),
        jnp.asarray(seeded_tokens(2, 3)), jcfg))[0, -1]
    np.testing.assert_allclose(np.asarray(got["logits"]), want, rtol=2e-4,
                               atol=2e-4)
    assert int(np.argmax(got["logits"])) == int(np.argmax(want))


# -- (e) the link line -------------------------------------------------------


def test_binary_links_no_protobuf(demo_bin):
    ldd = _run(["ldd", demo_bin])
    assert ldd.returncode == 0, ldd.stderr
    assert "libstdc++" in ldd.stdout, ldd.stdout
    assert "protobuf" not in ldd.stdout, ldd.stdout
