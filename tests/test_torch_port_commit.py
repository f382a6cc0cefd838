"""Async checkpoint commit across ranks (``ckpt/manager.py`` at a world
above one), the counterpart of ``tests/test_goodput.py``'s
kill-during-commit drill, on a gloo world of two ranks through
``tests/_torch_multirank.py``:

- with ``ASYNC_CKPT=1`` every rank's manager commits in the background
  on a gloo group of its own, and every commit is logged "ok" on both;
- ``FAULT_SPEC`` ``kill_during_commit`` at step 4 (a storage delay holds
  the commit open) kills both ranks with the commit of step 4 torn on
  both: ``COMMITTING.4`` on disk, no ``COMMITTED.4``, step 2 committed;
- the resume sweeps step 4 (its marker, and its data when the write had
  landed), takes step 2, and every later loss is bitwise the
  uninterrupted run's.
"""

import json
import os

import pytest

from tests import _torch_multirank as mr
from tests.test_torch_port_elastic import _job, _read


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from mr.one_torch_thread()


def test_kill_during_commit_across_two_ranks_resumes_bitwise(tmp_path):
    env = {"ASYNC_CKPT": "1", "PYTHONHASHSEED": "0"}
    cut = {"MESH_FSDP": 2, "max_samples": 32}
    ref = _job(str(tmp_path / "ref"), "U", str(tmp_path / "u"))
    kill = _job(str(tmp_path / "kill"), "K", str(tmp_path / "k"),
                env={"FAULT_SPEC": "kind=kill_during_commit:step=4",
                     "CKPT_STORAGE_DELAY_S": "0.5"})
    for out in (ref, kill):
        job = json.load(open(os.path.join(out, "job.json")))
        job["config"].update(cut)
        json.dump(job, open(os.path.join(out, "job.json"), "w"))
    procs = [mr.start("pretrain", out, n=2, extra_env=env)
             for out in (ref, kill)]
    for p in procs:
        mr.wait(p, timeout=180)
    u, k = _read(ref, "U", 2), _read(kill, "K", 2)
    for rank in u:
        assert rank["status"] == "ok"
        c = rank["commits"][0]
        assert c["async"] and c["own_group"]
        assert [(e["step"], e["status"]) for e in c["log"]] == [
            (2, "ok"), (4, "ok"), (6, "ok"), (8, "ok")]
    for rank in k:
        assert rank["status"] == "failed"
        assert "injected kill during commit of step 4" in rank["error"]
        assert [(e["step"], e["status"]) for e in
                rank["commits"][0]["log"]] == [(2, "ok"), (4, "torn")]
    d = str(tmp_path / "k" / "lm")
    assert os.path.exists(os.path.join(d, "COMMITTING.4"))
    assert not os.path.exists(os.path.join(d, "COMMITTED.4"))
    assert os.path.exists(os.path.join(d, "COMMITTED.2"))
    res = _job(str(tmp_path / "resume"), "R", str(tmp_path / "k"))
    job = json.load(open(os.path.join(res, "job.json")))
    job["config"].update(cut)
    json.dump(job, open(os.path.join(res, "job.json"), "w"))
    mr.wait(mr.start("pretrain", res, n=2, extra_env=env), timeout=180)
    r = _read(res, "R", 2)
    # the torn step never existed: its marker is swept, any data of it
    # quarantined
    assert not os.path.exists(os.path.join(d, "COMMITTING.4"))
    assert not os.path.isdir(os.path.join(d, "4")) or \
        os.path.exists(os.path.join(d, "COMMITTED.4"))
    for rank in r:
        assert rank["status"] == "ok"
        assert rank["log"][0]["resumed_step"] == 2
        assert sorted(rank["losses"], key=int) == [str(s) for s in
                                                   range(3, 9)]
        assert all(rank["losses"][s] == u[0]["losses"][s]
                   for s in rank["losses"])
    # the killed run's steps before the kill are the same run
    assert all(k[0]["losses"][s] == u[0]["losses"][s]
               for s in k[0]["losses"])
