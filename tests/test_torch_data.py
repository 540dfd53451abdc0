"""The port's data plane (``ray_tpu_torch.data``, ``air.preprocessors``)
against ``ray_tpu``'s.

Each parity scenario is one function ``scenario(pkg, tmp)``, run under
``ray_tpu`` and under ``ray_tpu_torch`` in turns (each package holds one
runtime for the module, both live at once), on the same seeded numpy
inputs. What they return, and the class names of what they raise, must be
equal. The scenarios mirror ``tests/test_data.py`` and the preprocessor
cases of ``tests/test_air_extras.py``. Then the device feed:
``iter_device_batches(device="cpu")`` against ``iter_jax_batches``, its
sharded form on a world-size-1 CPU mesh, and the array-column fault the
port fixes. Checks that need a card are in ``chip_smoke.py``'s phase 20.
"""

import importlib
import random
import socket
import threading
import time

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import torch.distributed as dist

import ray_tpu
import ray_tpu.air.preprocessors  # noqa: F401
import ray_tpu.data  # noqa: F401
import ray_tpu_torch
import ray_tpu_torch.air.preprocessors  # noqa: F401
import ray_tpu_torch.data  # noqa: F401

PKGS = (ray_tpu, ray_tpu_torch)
SCENARIOS = {}
DIR_FLAGS = ("flight_recorder_dir", "object_spilling_dir", "event_log_dir",
             "log_dir", "drain_checkpoint_root")


def sub(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


@pytest.fixture(scope="module", autouse=True)
def runtimes(tmp_path_factory):
    """One ``init(num_cpus=8)`` per package for the module, its files under
    pytest's temporary directory; the flags are restored afterwards."""
    saved = []
    for pkg in PKGS:
        config = sub(pkg, "_private.config")._config
        saved.append((config, dict(config._values)))
        root = tmp_path_factory.mktemp(pkg.__name__)
        for flag in DIR_FLAGS:
            config.set(flag, str(root / flag))
        pkg.shutdown()
        pkg.init(num_cpus=8)
    yield
    for pkg in PKGS:
        pkg.shutdown()
    for config, values in saved:
        config._values = values


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def plain(x):
    """``x`` with numpy arrays and scalars as Python values (NaN as the
    string "nan"), so results of the two packages compare with ``==``."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, pd.DataFrame):
        return {"columns": list(x.columns),
                "rows": plain(x.to_dict(orient="records"))}
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        x = x.item()
    if isinstance(x, float) and x != x:
        return "nan"
    return x


def raised(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except Exception as e:
        return type(e).__name__
    return None


# -- transforms (tests/test_data.py) -----------------------------------------

@scenario
def range_and_count(pkg, tmp):
    rd = pkg.data
    ds = rd.range(100, parallelism=5)
    return ds.count(), ds.num_blocks(), ds.take(3), rd.range(0).count()


@scenario
def map_filter_flat_map(pkg, tmp):
    out = (pkg.data.from_items(list(range(20)))
           .map(lambda x: x * 2)
           .filter(lambda x: x % 4 == 0)
           .flat_map(lambda x: [x, x + 1]))
    return out.take_all(), out.count()


@scenario
def stage_fusion(pkg, tmp):
    ds = pkg.data.range(10, parallelism=2).map(lambda x: x + 1).filter(
        lambda x: True).map(lambda x: x * 2)
    return len(ds.get_internal_block_refs()), ds.take_all(), repr(ds)


@scenario
def map_batches_pandas_and_numpy(pkg, tmp):
    rd = pkg.data
    df = pd.DataFrame({"a": range(10), "b": range(10)})
    out = rd.from_pandas(df).map_batches(lambda d: d.assign(c=d.a + d.b),
                                         batch_format="pandas")
    out2 = rd.range_table(8).map_batches(
        lambda batch: {"value": batch["value"] * 3}, batch_format="numpy",
        batch_size=3)
    return plain(out.to_pandas()), plain(out2.to_pandas())


@scenario
def column_ops(pkg, tmp):
    ds = pkg.data.range_table(5).add_column("sq", lambda df: df["value"] ** 2)
    return (plain(ds.select_columns(["sq"]).to_pandas()),
            ds.rename_columns({"sq": "square"}).columns(),
            ds.drop_columns(["value"]).columns(), ds.schema())


@scenario
def repartition(pkg, tmp):
    ds = pkg.data.range(100, parallelism=10).repartition(3)
    return ds.num_blocks(), ds.count(), ds.take_all()


@scenario
def seeded_random_shuffle(pkg, tmp):
    rows = pkg.data.range(200, parallelism=4).random_shuffle(seed=7).take_all()
    return rows, sorted(rows) == list(range(200))


@scenario
def sort_simple_and_tabular(pkg, tmp):
    rd = pkg.data
    items = list(range(50))
    random.Random(3).shuffle(items)
    df = pd.DataFrame({"k": items, "v": [i * 2 for i in items]})
    return (rd.from_items(items, parallelism=4).sort().take_all(),
            plain(rd.from_pandas(df).sort("k").to_pandas()),
            rd.from_items(items, parallelism=4).sort(
                descending=True).take_all())


@scenario
def groupby_aggregates(pkg, tmp):
    rd = pkg.data
    df = pd.DataFrame({"g": [i % 3 for i in range(30)],
                       "x": np.random.default_rng(0).standard_normal(30)})
    ds = rd.from_pandas(df)
    out = [plain(getattr(ds.groupby("g"), fn)(*args).to_pandas()
                 .sort_values("g").reset_index(drop=True))
           for fn, args in (("sum", ("x",)), ("count", ()), ("max", ("x",)),
                            ("min", ("x",)), ("mean", ("x",)),
                            ("std", ("x",)))]
    agg = ds.groupby("g").aggregate(("sum", "x", "s"), ("count", None, "n"))
    groups = rd.from_items([{"g": i % 2, "x": i} for i in range(10)]) \
        .groupby(lambda r: r["g"]).map_groups(
            lambda block: [{"g": block.iloc[0]["g"], "n": len(block)}])
    return (out, plain(agg.to_pandas().sort_values("g")
                       .reset_index(drop=True)),
            plain(sorted(groups.take_all(), key=lambda r: r["g"])))


@scenario
def global_aggregates(pkg, tmp):
    rd = pkg.data
    ds = rd.range(10)
    tab = rd.range_table(10)
    return (ds.sum(), ds.min(), ds.max(), ds.mean(), ds.std(),
            tab.sum("value"), rd.from_items([]).sum(),
            raised(rd.from_items([{"a": 1, "b": 2}]).sum))


@scenario
def zip_and_union(pkg, tmp):
    rd = pkg.data
    a = rd.range(5)
    b = rd.range(5).map(lambda x: x * 10)
    return (a.zip(b).take_all(), sorted(a.union(b).take_all()),
            raised(lambda: a.zip(rd.range(4)).take_all()))


@scenario
def limit_take_show(pkg, tmp):
    ds = pkg.data.range(100, parallelism=4)
    return ds.limit(7).count(), ds.limit(7).take_all(), ds.take(3)


@scenario
def splits(pkg, tmp):
    rd = pkg.data
    ds = rd.range(30, parallelism=6)
    parts = [p.take_all() for p in ds.split(3)]
    eq = [p.take_all() for p in ds.split(4, equal=True)]
    cut = [p.take_all() for p in ds.split_at_indices([10])]
    uneven = rd.from_items(list(range(103))).repartition(7)
    eq103 = [p.take_all() for p in uneven.split(4, equal=True)]
    three = [p.take_all() for p in rd.from_items(list(range(50)))
             .repartition(6).split_at_indices([10, 35])]
    tr, te = rd.range(100).train_test_split(0.2)
    return (parts, eq, cut, [len(p) for p in eq103], eq103, three,
            tr.count(), te.count())


@scenario
def streaming_split(pkg, tmp):
    ds = pkg.data.from_items(list(range(100))).repartition(8)
    shards = [list(it.iter_rows()) for it in ds.streaming_split(3)]
    eq = ds.streaming_split(4, equal=True)
    return (shards, [it.count() for it in eq], type(eq[0]).__name__,
            [list(it.materialize().take_all()) for it in eq])


@scenario
def iter_batches_formats(pkg, tmp):
    ds = pkg.data.range_table(25)
    pandas = [plain(b) for b in ds.iter_batches(batch_size=10,
                                                batch_format="pandas")]
    numpy = [plain(b) for b in ds.iter_batches(batch_size=25,
                                               batch_format="numpy")]
    dropped = [len(b) for b in ds.iter_batches(batch_size=10,
                                               drop_last=True)]
    simple = [plain(b) for b in pkg.data.range(7).iter_batches(
        batch_size=3, batch_format="numpy")]
    torch_batches = [{k: (str(v.dtype), v.tolist()) for k, v in b.items()}
                     for b in ds.iter_torch_batches(batch_size=10)]
    return pandas, numpy, dropped, simple, torch_batches


@scenario
def local_shuffle(pkg, tmp):
    return list(pkg.data.range(50).iter_batches(
        batch_size=50, batch_format="numpy", local_shuffle_buffer_size=20,
        local_shuffle_seed=1))[0].tolist()


@scenario
def io_round_trips(pkg, tmp):
    rd = pkg.data
    df = pd.DataFrame({"a": range(20), "b": [f"s{i}" for i in range(20)]})
    ds = rd.from_pandas(df).repartition(3)
    out = {}
    for fmt, reader in (("parquet", rd.read_parquet), ("csv", rd.read_csv),
                        ("json", rd.read_json)):
        path = str(tmp / fmt)
        getattr(ds, f"write_{fmt}")(path)
        back = reader(path).to_pandas().sort_values("a")
        out[fmt] = plain(back.reset_index(drop=True))
    rd.range_table(10).write_numpy(str(tmp / "np"), column="value")
    out["numpy"] = sorted(r["value"] for r in
                          rd.read_numpy(str(tmp / "np")).take_all())
    text = tmp / "t.txt"
    text.write_text("a\nb\nc\n")
    out["text"] = rd.read_text(str(text)).take_all()
    out["binary"] = rd.read_binary_files(str(text)).take_all()
    return out


@scenario
def tfrecords_round_trip_and_bytes(pkg, tmp):
    rd = pkg.data
    rows = [{"name": f"item-{i}", "score": float(i) / 2,
             "tags": [i, i * 2, i * 3], "blob": bytes([i, i + 1])}
            for i in range(20)]
    out = tmp / "tfr"
    rd.from_pandas(pd.DataFrame(rows)).write_tfrecords(str(out))
    files = {f.name: f.read_bytes() for f in sorted(out.iterdir())}
    back = rd.read_tfrecords(str(out)).to_pandas().sort_values(
        "score").reset_index(drop=True)
    big = 16_777_217
    mixed = tmp / "mixed"
    rd.from_pandas(pd.DataFrame({"id": [big, big + 1],
                                 "score": [0.5, 1.5]})).write_tfrecords(
        str(mixed))
    ids = sorted(rd.read_tfrecords(str(mixed)).to_pandas()["id"].tolist())
    return files, plain(back), ids


@scenario
def tfrecord_codec_and_crc(pkg, tmp):
    tf = sub(pkg, "data.tfrecords")
    p = tmp / "x.tfrecord"
    tmp.mkdir(parents=True, exist_ok=True)
    tf.write_tfrecord_file(str(p), [tf.encode_example({"a": 1})])
    raw = bytearray(p.read_bytes())
    raw[-5] ^= 0xFF
    p.write_bytes(bytes(raw))
    rec = tf.encode_example({"neg": -7, "many": [-1, 0, 1], "f": 0.25,
                             "s": "x", "b": b"\x00\x01"})
    empty_float = tf._ld(1, tf._ld(1, b"e") + tf._ld(2, tf._ld(2, b"")))
    crcs = [(tf.crc32c(d), tf._masked_crc(d))
            for d in (b"", b"123456789", bytes(32), rec)]
    return (raised(lambda: list(tf.read_tfrecord_file(str(p)))),
            rec, plain(tf.decode_example(rec)), crcs,
            tf.decode_example(bytes(tf._ld(1, bytes(empty_float))))["e"])


@scenario
def actor_pool_compute(pkg, tmp):
    rd = pkg.data
    ds = rd.range(40, parallelism=4).map(
        lambda x: x + 1, compute=rd.ActorPoolStrategy(min_size=2))
    return ds.take_all()


@scenario
def pipelines(pkg, tmp):
    rd = pkg.data
    pipe = rd.range(20, parallelism=4).window(blocks_per_window=2)
    rep = rd.range(5).repeat(3)
    epochs = list(rep.iter_epochs())
    shards = rd.range(20, parallelism=4).window(blocks_per_window=2).split(2)
    batches = [b.tolist() for b in rd.range(10, parallelism=2).window(
        blocks_per_window=1).iter_batches(batch_size=4,
                                          batch_format="numpy")]
    return (pipe.count(), pipe.map(lambda x: x * 2).take(5), rep.count(),
            len(epochs), epochs[0].count(), [s.count() for s in shards],
            batches)


@scenario
def random_sample(pkg, tmp):
    return (pkg.data.range(1000).random_sample(0.1, seed=5).take_all(),
            pkg.data.range_table(100).random_sample(0.2, seed=5).count())


@scenario
def prefetch_matches_and_propagates_errors(pkg, tmp):
    rd = pkg.data
    ds = rd.from_items([{"x": i} for i in range(64)])
    plain_b = [b["x"].tolist() for b in
               ds.iter_batches(batch_size=16, batch_format="numpy")]
    pref = [b["x"].tolist() for b in
            ds.iter_batches(batch_size=16, batch_format="numpy",
                            prefetch_batches=2)]

    def boom(x):
        if x == 20:
            raise ValueError("producer boom")
        return x

    try:
        for _ in rd.from_items(list(range(32))).map(boom).iter_batches(
                batch_size=8, prefetch_batches=2):
            pass
        err = None
    except Exception as e:
        err = (type(e).__name__, "producer boom" in str(e))
    return plain_b, plain_b == pref, err


@scenario
def prefetch_abandonment_releases_producer(pkg, tmp):
    ds = pkg.data.from_items(list(range(1000)))
    before = {t.ident for t in threading.enumerate()}
    for _ in range(5):
        it = ds.iter_batches(batch_size=10, prefetch_batches=2)
        next(it)
        it.close()
    deadline = time.monotonic() + 5
    while True:
        lingering = [t for t in threading.enumerate()
                     if t.name == "data-prefetch" and t.is_alive()
                     and t.ident not in before]
        if not lingering or time.monotonic() > deadline:
            return len(lingering)
        time.sleep(0.05)


def random_access_over(pkg, rows, num_workers, blocks, fn):
    """``fn(rad)`` over a ``RandomAccessDataset`` of ``rows``, whose worker
    actors (1 CPU each) are killed afterwards: the module's runtimes live
    on."""
    rd = pkg.data
    rad = rd.RandomAccessDataset(rd.from_items(rows).repartition(blocks),
                                 "id", num_workers=num_workers)
    try:
        return fn(rad)
    finally:
        for w in rad._workers:
            pkg.kill(w)


@scenario
def random_access(pkg, tmp):
    rows = [{"id": i, "val": i * 10} for i in range(200)]
    random.Random(0).shuffle(rows)
    return random_access_over(pkg, rows, 3, 6, lambda rad: (
        plain([rad.get(k) for k in (0, 199, 123, 777)]),
        plain(rad.multiget([5, 150, 42, 999, 63])),
        sum(s["rows"] for s in rad.stats())))


@scenario
def random_access_skewed_and_empty(pkg, tmp):
    skew = random_access_over(
        pkg, [{"id": i // 10, "val": i} for i in range(100)], 4, 5,
        lambda rad: ([rad.get(k) is not None for k in (0, 9, 10)],
                     sum(s["rows"] for s in rad.stats())))
    empty = random_access_over(pkg, [], 2, 1, lambda rad: (
        rad.get(1), rad.multiget([1, 2])))
    return skew, empty


@scenario
def all_empty_tabular_keeps_schema(pkg, tmp):
    ds = (pkg.data.from_items([{"id": i, "val": i} for i in range(10)])
          .filter(lambda r: False).repartition(2))
    df = ds.to_pandas()
    return list(df.columns), len(df)


@scenario
def array_columns_as_numpy_batches(pkg, tmp):
    """``iter_batches(batch_format="numpy")`` keeps the reference's object
    column of per-row arrays in both packages."""
    tokens = np.random.default_rng(1).integers(0, 9, (6, 4))
    batch = next(pkg.data.from_numpy(tokens).iter_batches(
        batch_size=6, batch_format="numpy"))
    return str(batch["value"].dtype), plain(list(batch["value"]))


# -- preprocessors (tests/test_air_extras.py) --------------------------------

def tabular_ds(pkg):
    rows = [{"x": float(i), "y": float(i * 2), "label": "ab"[i % 2]}
            for i in range(20)]
    return pkg.data.from_items(rows, parallelism=4)


@scenario
def standard_scaler(pkg, tmp):
    pre = sub(pkg, "air.preprocessors")
    scaler = pre.StandardScaler(columns=["x"])
    out = scaler.fit_transform(tabular_ds(pkg))
    return plain(out.take_all()), plain(scaler.stats_)


@scenario
def minmax_label_onehot_imputer(pkg, tmp):
    pre = sub(pkg, "air.preprocessors")
    ds = tabular_ds(pkg)
    nan_rows = [{"v": 1.0}, {"v": float("nan")}, {"v": 3.0}]
    return (plain(pre.MinMaxScaler(columns=["y"]).fit_transform(ds)
                  .take_all()),
            plain(pre.LabelEncoder("label").fit_transform(ds).take_all()),
            plain(pre.OneHotEncoder(columns=["label"]).fit_transform(ds)
                  .take(3)),
            plain(pre.SimpleImputer(columns=["v"]).fit_transform(
                pkg.data.from_items(nan_rows, parallelism=1)).take_all()),
            raised(pre.StandardScaler(columns=["x"]).transform, ds))


@scenario
def chain_and_batch_mapper(pkg, tmp):
    pre = sub(pkg, "air.preprocessors")
    chain = pre.Chain(pre.StandardScaler(columns=["x"]),
                      pre.BatchMapper(lambda b: {**b, "x2": b["x"] * 2}))
    out = chain.fit_transform(tabular_ds(pkg))
    batch = chain.transform_batch({"x": np.array([0.0]),
                                   "y": np.array([1.0]),
                                   "label": np.array(["a"])})
    return plain(out.take(3)), plain(batch)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax_package(name, tmp_path):
    fn = SCENARIOS[name]
    got = {}
    for pkg in PKGS:
        try:
            got[pkg.__name__] = fn(pkg, tmp_path / pkg.__name__)
        except Exception as e:
            got[pkg.__name__] = ("raised", type(e).__name__, str(e)[:200])
    want = got["ray_tpu"]
    assert not (isinstance(want, tuple) and want[:1] == ("raised",)), want
    assert got["ray_tpu_torch"] == want


# -- the device feed ----------------------------------------------------------

def feeds():
    """Datasets both packages build from the same seeded numpy inputs."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(37).astype(np.float32)
    y = rng.integers(0, 100, 37)
    return [lambda rd: rd.range_table(25),
            lambda rd: rd.range(19),
            lambda rd: rd.from_items([{"x": float(a), "y": int(b)}
                                      for a, b in zip(x, y)], parallelism=3),
            lambda rd: rd.range(19, parallelism=3).window(
                blocks_per_window=2)]


@pytest.mark.parametrize("feed", range(4))
@pytest.mark.parametrize("prefetch", [0, 2])
def test_device_batches_equal_jax_batches(feed, prefetch):
    make = feeds()[feed]
    kw = dict(batch_size=8, prefetch_batches=prefetch)
    want = list(make(ray_tpu.data).iter_jax_batches(**kw))
    ds = make(ray_tpu_torch.data)
    got = list(ds.iter_device_batches(device="cpu", **kw))
    if isinstance(ds, ray_tpu_torch.data.DatasetPipeline):
        via_iterator = got       # a pipeline has no iterator()
    else:
        via_iterator = list(ds.iterator().iter_device_batches(device="cpu",
                                                              **kw))
    assert len(got) == len(want) == len(via_iterator) > 0
    for g, w, i in zip(got, want, via_iterator):
        if not isinstance(w, dict):
            g, w, i = {"": g}, {"": w}, {"": i}
        assert g.keys() == w.keys() == i.keys()
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            assert g[k].device.type == "cpu"
            # jax keeps 32-bit types unless x64 is on; the port keeps numpy's
            assert g[k].numpy().tolist() == np.asarray(w[k]).tolist()
            assert torch.equal(g[k], i[k])


def test_device_batches_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: phase 20 of chip_smoke.py")
    ds = ray_tpu_torch.data.range(4)
    with pytest.raises(RuntimeError, match="cuda"):
        ds.iter_device_batches()
    with pytest.raises(RuntimeError, match="cuda"):
        ds.iterator().iter_device_batches(batch_size=2)


@pytest.fixture(scope="module")
def cpu_world():
    """A gloo world of one in this process (torch's default world is
    process-wide), destroyed at the end unless it was there before."""
    owned = not dist.is_initialized()
    if owned:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    yield
    if owned:
        dist.destroy_process_group()


def test_sharded_device_batches_match_jax_on_a_one_device_mesh(cpu_world):
    from jax.sharding import NamedSharding, PartitionSpec
    from torch.distributed.tensor import DTensor

    from ray_tpu.parallel import MeshConfig as JaxMeshConfig
    from ray_tpu.parallel import build_mesh as jax_build_mesh
    from ray_tpu_torch.parallel import MeshConfig, batch_sharding, build_mesh
    tokens = np.random.default_rng(4).integers(0, 64, (16, 9)).astype(
        np.int32)
    jmesh = jax_build_mesh(JaxMeshConfig(data=1), jax.devices()[:1])
    jsharding = NamedSharding(jmesh, PartitionSpec(("data", "fsdp")))
    want = list(ray_tpu.data.from_items(list(tokens)).iter_jax_batches(
        batch_size=8, sharding=jsharding))
    mesh = build_mesh(MeshConfig(data=1), "cpu")
    ds = ray_tpu_torch.data.from_numpy([tokens[:8], tokens[8:]])
    got = list(ds.iterator().iter_device_batches(
        batch_size=8, device="cpu", sharding=(mesh, batch_sharding(mesh)),
        prefetch_batches=1))
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        g = g["value"]
        assert isinstance(g, DTensor) and g.shape == (8, 9)
        assert w.sharding.is_equivalent_to(jsharding, 2)
        assert g.to_local().tolist() == np.asarray(w).tolist() == \
            tokens[8 * i:8 * (i + 1)].tolist()
        assert g.full_tensor().dtype == torch.int32
    with pytest.raises(ValueError, match="mesh"):
        ds.iter_device_batches(device="meta",
                               sharding=(mesh, batch_sharding(mesh)))


def test_array_columns_become_tensors_in_the_port_only():
    """Fault (a) of the JAX package: a tabular column of per-row arrays
    (``from_numpy`` of a 2-D token array, ``from_items`` of dicts holding
    arrays) reaches ``iter_jax_batches`` and ``iter_torch_batches`` as an
    object array, and both raise ``TypeError``; the port stacks it."""
    tokens = np.random.default_rng(5).integers(0, 1000, (12, 7))
    lengths = np.arange(1, 13)
    items = [{"tokens": t, "length": n} for t, n in zip(tokens, lengths)]
    for make in (lambda rd: rd.from_numpy(tokens),
                 lambda rd: rd.from_items(items, parallelism=3)):
        jds = make(ray_tpu.data)
        with pytest.raises(TypeError):
            next(jds.iter_jax_batches(batch_size=12))
        with pytest.raises(TypeError):
            next(jds.iter_torch_batches(batch_size=12))
        ds = make(ray_tpu_torch.data)
        col = "value" if "value" in ds.columns() else "tokens"
        for batch in (next(ds.iter_device_batches(batch_size=12,
                                                  device="cpu")),
                      next(ds.iter_torch_batches(batch_size=12))):
            assert batch[col].shape == (12, 7)
            assert batch[col].dtype == torch.int64
            assert np.array_equal(batch[col].numpy(), tokens)
    # anything else still raises: strings, ragged rows
    ragged = ray_tpu_torch.data.from_items(
        [{"t": np.arange(n)} for n in (2, 3)])
    with pytest.raises(TypeError):
        next(ragged.iter_torch_batches(batch_size=2))
    words = ray_tpu_torch.data.from_items([{"w": "a"}, {"w": "b"}])
    with pytest.raises(TypeError):
        next(words.iter_device_batches(batch_size=2, device="cpu"))
