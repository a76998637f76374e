"""The port's mesh across processes: ``torch.distributed`` over gloo.

The counterpart of ``tests/test_multihost.py`` and
``tests/mp_mesh_worker.py``. Two OS processes, each driving two CPU ranks,
join one process group through ``initialize_multihost``; each runs the
three engines of the JAX worker — local, mesh-COO on a (4, 1) mesh and
mesh-ELL on a (2, 2) mesh, the ``docs`` axis across the process boundary
and ``terms`` inside each process — through ingest, commit, search, then
an append and a commit. Every process must answer as its local engine
does, the processes as each other, and all as the JAX package's local
engine on the same texts (4-decimal scores, as the JAX worker compares).
``jax`` and ``tfidf_tpu`` are made unimportable in the processes.

This file is also the processes' program: ``python
tests/test_torch_multihost.py <host:port> <n> <pid> <dir>`` runs one of
them.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = {
    "a.txt": "the quick brown fox jumps over the lazy dog",
    "b.txt": "a fast brown fox and a quick red fox",
    "c.txt": "lorem ipsum dolor sit amet",
    "d.txt": "the dog sleeps all day long",
    "e.txt": "red dogs chase brown foxes at dawn",
    "f.txt": "ipsum lorem amet dolor",
    "g.txt": "quick quick quick brown brown dog",
    "h.txt": "foxes and dogs and foxes again",
    "i.txt": "dawn chorus over the lazy meadow",
    "j.txt": "meadow fox naps in the red dawn",
}
QUERIES = ("fox", "brown dog", "lorem ipsum", "red dawn", "meadow",
           "nosuchterm")
APPEND = ("k.txt", "zebra fox dawn")
SMALL = dict(min_doc_capacity=8, min_nnz_capacity=256,
             min_vocab_capacity=64, query_batch=4, max_query_terms=8)
PROC_TIMEOUT_S = 120
JOINED = "MP_JOINED"   # a process prints it once its group has formed


def results(engine):
    return [sorted(([h.name, round(h.score, 4)] for h in engine.search(q)),
                   key=lambda nv: (-nv[1], nv[0])) for q in QUERIES]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(code_args, n, timeout=PROC_TIMEOUT_S, attempts=3):
    """Start ``n`` processes of this file's program (``code_args(i,
    port)``: process i's arguments around a free port from the OS) and
    collect their output; the processes share one deadline and are
    killed past it.

    A port picked here can be taken by another process of the box before
    the group's store binds it, or the store's clients can reach whatever
    took it: the group then never forms (a bind error, a refused or reset
    connection, or a hang). So when a process failed or hung BEFORE every
    process printed ``MP_JOINED`` (the group formed), the run starts
    again on a new port; a failure after the group formed is the code's,
    and raises with the processes' output at once."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    for attempt in range(attempts):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             *code_args(i, port)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(n)]
        deadline = time.monotonic() + timeout
        outs, hung = [], []
        try:
            for i, p in enumerate(procs):
                try:
                    out, _ = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                    hung.append(i)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [i for i, p in enumerate(procs)
                  if p.returncode != 0 or i in hung]
        if not failed:
            return outs
        joined = all(JOINED in o for o in outs)
        if not joined and attempt < attempts - 1:
            continue
        i = failed[0]
        raise AssertionError((i, "hung past the deadline" if i in hung
                              else f"exit {procs[i].returncode}",
                              "group formed" if joined
                              else "group never formed", outs[i][-4000:]))


def _answers(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("MP_ANSWERS ")]
    assert len(line) == 1, out[-4000:]
    return json.loads(line[0][len("MP_ANSWERS "):])


@pytest.mark.timeout(180)
def test_gloo_mesh_processes_answer_as_local_and_jax(tmp_path):
    from tfidf_tpu.engine.engine import Engine as JaxEngine
    from tfidf_tpu.utils.config import Config as JaxConfig

    outs = _run(lambda i, port: [f"127.0.0.1:{port}", "2", str(i),
                                 str(tmp_path)], 2)
    answers = [_answers(o) for o in outs]
    meshes = [a.pop("mesh") for a in answers]
    assert answers[0] == answers[1]
    jax = JaxEngine(JaxConfig(documents_path=str(tmp_path / "j"), **SMALL))
    for name, text in TEXTS.items():
        jax.ingest_text(name, text)
    jax.commit()
    want = json.loads(json.dumps(results(jax)))
    jax.ingest_text(*APPEND)
    jax.commit()
    want2 = json.loads(json.dumps(results(jax)))
    for label in ("local", "coo", "ell"):
        assert answers[0][label] == want, (label, answers[0][label], want)
        assert answers[0][label + "2"] == want2, label
    assert meshes == [
        {"coo": [4, 1], "ell": [2, 2], "procs": 2,
         "local_rows": {"coo": [0, 1], "ell": [0]}},
        {"coo": [4, 1], "ell": [2, 2], "procs": 2,
         "local_rows": {"coo": [2, 3], "ell": [1]}}]


@pytest.mark.timeout(120)
def test_initialize_multihost_single_process_group():
    """World size 1: the first call initializes and returns True, the
    second is a no-op returning False, and ``make_mesh()`` spans the
    process's devices through the process-group collectives."""
    out = _run(lambda i, port: ["--single", f"127.0.0.1:{port}"], 1)[0]
    assert "MP_SINGLE_OK" in out, out[-4000:]


def test_serve_distributed_flag_and_config():
    from tfidf_tpu_torch.cli import build_parser
    from tfidf_tpu_torch.utils.config import load_config
    assert build_parser().parse_args(["serve", "--distributed"]).distributed
    assert not build_parser().parse_args(["serve"]).distributed
    args = build_parser().parse_args(["serve", "--engine-mode", "mesh"])
    assert args.engine_mode == "mesh"
    cfg = load_config(env={"TFIDF_DISTRIBUTED": "true",
                           "TFIDF_DIST_COORDINATOR": "10.0.0.1:8476",
                           "TFIDF_DIST_NUM_PROCESSES": "4",
                           "TFIDF_DIST_PROCESS_ID": "2"})
    assert (cfg.distributed, cfg.dist_coordinator, cfg.dist_num_processes,
            cfg.dist_process_id) == (True, "10.0.0.1:8476", 4, 2)


# ---------------------------------------------------------------------------
# the processes' program
# ---------------------------------------------------------------------------

def _single(coord: str) -> None:
    from tfidf_tpu_torch.parallel import mesh as M
    from tfidf_tpu_torch.parallel.collectives import ProcessGroup
    assert M.initialize_multihost(coord, 1, 0, local_devices=["cpu"] * 2)
    print(JOINED, flush=True)
    assert M.initialize_multihost() is False
    m = M.make_mesh()
    assert isinstance(m.comm, ProcessGroup)
    assert m.shape == {"docs": 2, "terms": 1} and m.local_rows == [0, 1]
    print("MP_SINGLE_OK", flush=True)


def _worker(coord: str, n: int, pid: int, tmp: str) -> None:
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from tfidf_tpu_torch.utils.config import Config

    assert initialize_multihost(coord, num_processes=n, process_id=pid,
                                local_devices=["cpu", "cpu"])
    print(JOINED, flush=True)

    def cfg(mode, layout="coo"):
        return Config(documents_path=os.path.join(tmp, f"{mode}{layout}"
                                                  f"{pid}"),
                      engine_mode=mode, mesh_layout=layout,
                      embedding_enabled=False, **SMALL)

    local = Engine(cfg("local"), device="cpu")
    coo = Engine(cfg("mesh", "coo"), mesh=make_mesh((2 * n, 1)))
    ell = Engine(cfg("mesh", "ell"), mesh=make_mesh((n, 2)))
    engines = {"local": local, "coo": coo, "ell": ell}
    out = {}
    for e in engines.values():
        for name, text in TEXTS.items():
            e.ingest_text(name, text)
        e.commit()
    for label, e in engines.items():
        out[label] = results(e)
    for e in engines.values():
        e.ingest_text(*APPEND)
        e.commit()
    for label, e in engines.items():
        out[label + "2"] = results(e)
    assert out["coo"] == out["local"] and out["ell"] == out["local"], out
    out["mesh"] = {"coo": [coo.index.mesh.D, coo.index.mesh.T],
                   "ell": [ell.index.mesh.D, ell.index.mesh.T],
                   "procs": coo.index.mesh.comm.world,
                   "local_rows": {"coo": coo.index.mesh.local_rows,
                                  "ell": ell.index.mesh.local_rows}}
    print("MP_ANSWERS " + json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.modules["jax"] = None           # the port must not need either
    sys.modules["tfidf_tpu"] = None
    if sys.argv[1] == "--single":
        _single(sys.argv[2])
    else:
        _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                sys.argv[4])
