"""The port's leaf libraries against ``ray_tpu``'s: ``util.check_serialize``,
``util.multiprocessing``, ``util.joblib``, ``experimental.state`` and
``job``.

Both packages' in-process runtimes are live for the module, each declaring
4 CPUs and one GPU (the port through ``num_gpus=``, the JAX package through
``resources=``), so ``num_gpus`` requests place on the CPU here. Each
scenario ``fn(rt)`` runs under both and must return the same value. The
seams: a ``Pool`` whose tasks ask for half a GPU, the state API reporting a
GPU grant, the joblib backend registered under the reference's name by
each package in turn (``joblib`` imported only then), and a job's
subprocess seeing the caller's ``CUDA_VISIBLE_DEVICES`` unless ``env=``
overrides it.
"""

import importlib
import os
import subprocess
import sys
import tempfile
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = (ray_tpu, ray_tpu_torch)
SCENARIOS = {}


def sub(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    for rt in RUNTIMES:
        rt.shutdown()
    ray_tpu.init(num_cpus=4, resources={"GPU": 1})
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield
    for rt in RUNTIMES:
        rt.shutdown()


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _sq(x):
    return x * x


def _add(x, y):
    return x + y


def _boom(x):
    raise RuntimeError("boom")


# -- util.check_serialize ---------------------------------------------------

@scenario
def check_serialize_names_the_bad_leaf(rt):
    cs = sub(rt, "util.check_serialize")
    lock = threading.Lock()

    def closure_over_lock():
        return lock

    class Holder:
        def __init__(self):
            self.ok = 1
            self.bad = threading.Lock()

    out = [cs.inspect_serializability(lambda: 1)[0]]
    for obj in (closure_over_lock, Holder(), {"k": [lock]}):
        ok, failures = cs.inspect_serializability(obj, name="obj")
        out.append((ok, sorted((f.name, f.parent) for f in failures)))
    return out


# -- util.multiprocessing ----------------------------------------------------

@scenario
def pool_map_imap_starmap(rt):
    mp = sub(rt, "util.multiprocessing")
    with mp.Pool(processes=2, ray_remote_args={"num_gpus": 0.5}) as p:
        out = [p.map(_sq, range(10)),
               list(p.imap(_sq, range(6), chunksize=2)),
               sorted(p.imap_unordered(_sq, range(6))),
               p.starmap(_add, [(1, 2), (3, 4)]),
               p.apply(_add, (3, 4)),
               p.apply_async(_add, (1, 2)).get(timeout=30),
               p.map_async(_sq, [1, 2, 3], chunksize=3).get(timeout=30)]
        try:
            p.map(_boom, [1])
        except Exception as e:
            out.append("boom" in str(e))
    closed = mp.Pool(processes=1)
    closed.close()
    try:
        closed.imap(_sq, [1])
    except ValueError as e:
        out.append(str(e))
    return out


# -- experimental.state ------------------------------------------------------

@scenario
def state_api_rows(rt):
    state = sub(rt, "experimental.state")

    @rt.remote
    def listed_task():
        return 1

    @rt.remote(num_gpus=1)
    class GpuActor:
        def ping(self):
            return "pong"

    before = state.summarize_tasks()["by_state"].get("FINISHED", 0)
    refs = [listed_task.remote() for _ in range(4)]   # held: names kept
    rt.get(refs)
    actor = GpuActor.remote()
    rt.get(actor.ping.remote())
    actors = [{k: a[k] for k in ("class_name", "state", "name", "restarts")}
              for a in state.list_actors()]
    nodes = [{k: n[k] for k in ("state", "resources_total",
                                "resources_available")}
             for n in state.list_nodes()]
    summary = state.summarize_tasks()
    name = next(t["name"] for t in state.list_tasks()
                if t["name"].endswith("listed_task"))
    rows = state.list_tasks(filters=[("name", "=", name)])
    rt.kill(actor)
    return (actors, nodes, [r["state"] for r in rows],
            summary["by_func_name"][name],
            summary["by_state"]["FINISHED"] - before,
            state.summarize_actors()["by_class"])


# -- util.joblib -------------------------------------------------------------

def test_joblib_backend_matches_jax():
    """Each package registers the backend under the reference's name in
    turn; the same batches give the same results."""
    import joblib
    out = {}
    for rt in RUNTIMES:
        jl = sub(rt, "util.joblib")
        assert jl.register_ray is jl.register_ray_tpu
        jl.register_ray_tpu()
        with joblib.parallel_backend("ray_tpu", n_jobs=4):
            out[rt.__name__] = joblib.Parallel()(
                joblib.delayed(_sq)(i) for i in range(10))
            backend = joblib.parallel.get_active_backend()[0]
        assert type(backend).__module__ == jl.__name__
    assert out["ray_tpu_torch"] == out["ray_tpu"] == [i * i
                                                      for i in range(10)]


def test_joblib_is_imported_only_when_registered():
    code = ("import sys, ray_tpu_torch.util, ray_tpu_torch.util.joblib; "
            "print('joblib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, env=_env())
    assert out.stdout.strip() == "False", out.stderr[-2000:]


# -- job ---------------------------------------------------------------------

def _job_lifecycle(rt, job_dir):
    job = sub(rt, "job")
    mgr = job.JobManager(job_dir=job_dir)
    ok = mgr.submit_job(entrypoint="echo job ran ok", submission_id="ok")
    bad = mgr.submit_job(entrypoint="exit 3", submission_id="bad")
    env = mgr.submit_job(entrypoint='echo "cards=[$CUDA_VISIBLE_DEVICES]"',
                         submission_id="env", env={"CUDA_VISIBLE_DEVICES":
                                                   "7"})
    inherit = mgr.submit_job(
        entrypoint='echo "cards=[$CUDA_VISIBLE_DEVICES]"',
        submission_id="inherit")
    slow = mgr.submit_job(entrypoint="sleep 60", submission_id="slow")
    out = [mgr.wait_until_finished(j, 30) for j in (ok, bad, env, inherit)]
    time.sleep(0.2)
    out += [mgr.stop_job(slow), mgr.wait_until_finished(slow, 30)]
    out += [mgr.get_job_logs(j).strip() for j in (ok, env, inherit)]
    out.append(mgr.get_job_info(bad).return_code)
    running = mgr.submit_job(entrypoint="sleep 60", submission_id="orphan")
    # a second manager on the same directory: the listing survives, and a
    # job that was running when its manager went away is FAILED
    again = job.JobManager(job_dir=job_dir)
    out.append(sorted((j.job_id, j.status) for j in again.list_jobs()))
    mgr.stop_job(running)
    mgr.wait_until_finished(running, 30)
    client = job.JobSubmissionClient(again)
    out.append((client.get_job_status("ok"),
                "".join(client.tail_job_logs("ok")).strip()))
    return out


def test_job_lifecycle_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    results = {}

    def run(rt):
        results[rt.__name__] = _job_lifecycle(rt, str(tmp_path / rt.__name__))

    threads = [threading.Thread(target=run, args=(rt,)) for rt in RUNTIMES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    assert results["ray_tpu_torch"] == results["ray_tpu"]
    assert results["ray_tpu_torch"][7:9] == ["cards=[7]", "cards=[0,1]"]


def test_default_job_dir_is_under_the_temporary_directory(tmp_path,
                                                          monkeypatch):
    from ray_tpu_torch.job import JobManager
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert JobManager().job_dir == str(tmp_path / "ray_tpu" / "jobs")
    assert (tmp_path / "ray_tpu" / "jobs").is_dir()


# -- the parity scenarios ----------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_matches_jax(name):
    fn = SCENARIOS[name]
    got, want = fn(ray_tpu_torch), fn(ray_tpu)
    assert got == want


def test_all_lists_equal_the_references():
    for name in ("workflow", "job", "experimental.state", "util.client",
                 "util.multiprocessing"):
        assert sub(ray_tpu_torch, name).__all__ == sub(ray_tpu,
                                                       name).__all__, name
    jax_autoscaler = sub(ray_tpu, "autoscaler").__all__
    assert sub(ray_tpu_torch, "autoscaler").__all__ == (
        jax_autoscaler + ["GPUNodeProvider"])
