"""The root ``bench.py``'s seven other modes on the CUDA card.

    python -m tfidf_tpu_torch bench --overload   # or --replay, --routers,
    python -m tfidf_tpu_torch.bench --kernel     # --hybrid, --tier, --compute

The port of the root ``bench.py``'s ``overload_main``, ``replay_main``,
``routers_main``, ``kernel_main``, ``hybrid_main``, ``tier_main`` and
``compute_main`` and everything they reach, with the same function
names, module constants, rng draw order (the same corpora for seed 0),
result keys and gates:

* ``--compute``: the host fallback against the healthy device path on one
  engine (``BENCH_r13.json``);
* ``--kernel``: one ELL block through the CUDA kernel's two variants, the
  plain version and ``torch.sparse.mm``; steady commit cost against corpus
  size on the segments and mesh indexes (``BENCH_r09.json``);
* ``--hybrid``: sparse, dense and fused q/s and MRR@10 over 20k textgen
  passages (``BENCH_r11.json``);
* ``--tier``: a corpus past the hot budget through the tier ring
  (``BENCH_r12.json``);
* ``--overload``: admitted-query p99 at 1x and 2x closed-loop load through
  a router, static watermarks then the SLO autopilot (``OVERLOAD.json``);
* ``--routers``: admitted q/s through 1, 2 and 4 routers at equal offered
  load (``BENCH_r07.json``);
* ``--replay``: capture admitted traffic at a router, replay it open-loop
  into a fresh one (``BENCH_r10.json``).

Every artifact goes through ``bench._emit_validated`` into
``build/bench/<name>`` beside the package (or ``BENCH_OUT``), never the
repository's root. Every gate is asserted before the artifact is
written. Each function takes its sizes and ``device`` as keyword
arguments (the module constants, and the card, by default); without
CUDA a mode refuses to run unless the caller passed ``device="cpu"``,
which runs every kernel's plain PyTorch version and every fleet node on
the CPU. In the fleet modes every ``serve`` node runs on ``device``; the
coordinator, the routers and the load generators never touch the card,
and on the card the run fails unless ``nvidia-smi`` counts exactly the
serving nodes (and this process, when it initialized CUDA) as the
card's processes.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from tfidf_tpu_torch.bench import (SEED, TOP_K, _emit_validated,
                                   _engine, _free_port, _http_get,
                                   _KeepAlive, _kill_all, _measured_window,
                                   _node_env, _wait_until, _worker_launches,
                                   card_info, lexicon_info, log,
                                   make_doc_arrays, make_queries, make_texts)

MODES = ("overload", "replay", "routers", "kernel", "hybrid", "tier",
         "compute")

# the card's published rates (NVIDIA H100 SXM data sheet, 700 W), as
# chip_smoke.py takes them for the kernel's bound
HBM_BYTES_PER_S = 3.35e12
F32_UNFUSED_OPS_PER_S = 33.5e12


def _device(device):
    """The mode's device: the card unless the caller named one (raises
    without CUDA, so no mode quietly measures the CPU)."""
    from tfidf_tpu_torch.device import resolve_device
    return resolve_device(device)


def _device_name(dev) -> str:
    """What a result's ``backend`` says: the card's name, or the device
    type off the card."""
    return card_info().get("name", "cuda") if dev.type == "cuda" \
        else dev.type


def _host(x) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def _ms(fn, dev, reps: int = 3, warm: bool = True) -> float:
    """Mean ms of ``fn`` (after one warm call): CUDA events on the card,
    the host clock around the work elsewhere."""
    if warm:
        fn()
    _sync(dev)
    if dev.type == "cuda":
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


# --------------------------------------------------------------------------
# shared fleet plumbing (overload, replay, routers)
# --------------------------------------------------------------------------

def _spawn(procs: list, env: dict, tmp: str, tag: str, args: list,
           extra_env: dict | None = None) -> subprocess.Popen:
    """One ``python -m tfidf_tpu_torch`` process, its stderr in
    ``tmp/<tag>.log``; it runs in ``tmp``, so it imports only what the
    environment's ``PYTHONPATH`` offers."""
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, f"{tag}.log"), "wb") as errf:
        p = subprocess.Popen(
            [sys.executable, "-m", "tfidf_tpu_torch", *args],
            env=dict(env, **(extra_env or {})), cwd=tmp,
            stdout=subprocess.DEVNULL, stderr=errf)
    procs.append(p)
    return p


def _spawn_routers(procs: list, env: dict, tmp: str, tags: list,
                   coord: int, extra_env: dict | None = None) -> list:
    """One ``router`` a tag, all started together on free ports, each
    answering ``/api/health``. A router that exits first because another
    process took its port between ``_free_port`` and its bind is started
    again on a fresh port; any other exit fails with its log. Returns
    [(the process, its port)] in the order of ``tags``."""
    def start(tag):
        port = _free_port()
        return _spawn(procs, env, tmp, tag,
                      ["router", "--port", str(port), "--host",
                       "127.0.0.1", "--coordinator", f"127.0.0.1:{coord}"],
                      extra_env), port

    def exited(tag, p) -> bool:
        if p.poll() is None:
            return False
        with open(os.path.join(tmp, f"{tag}.log"), errors="replace") as f:
            text = f.read()
        if "address already in use" not in text.lower():
            raise RuntimeError(f"[{tag}] router exited with "
                               f"{p.returncode}: {text[-2000:]}")
        return True

    out = [start(tag) for tag in tags]
    for _ in range(3):
        _wait_until(lambda: all(p.poll() is not None or _http_get(
            f"http://127.0.0.1:{port}/api/health") for p, port in out))
        taken = [i for i, (tag, (p, _)) in enumerate(zip(tags, out))
                 if exited(tag, p)]
        if not taken:
            return out
        for i in taken:
            out[i] = start(tags[i])
    raise RuntimeError(f"routers {tags}: ports taken three times")


def _serve_args(i: int, port: int, coord: int, tmp: str) -> list:
    """``serve`` arguments of node ``i`` (0 the leader) under ``tmp``."""
    return ["serve", "--port", str(port), "--host", "127.0.0.1",
            "--coordinator-address", f"127.0.0.1:{coord}",
            "--documents-path", f"{tmp}/n{i}/docs",
            "--index-path", f"{tmp}/n{i}/index"]


def _start_cluster(procs: list, env: dict, tmp: str, n_workers: int = 2,
                   coord: int | None = None, ports: list | None = None,
                   coord_args: tuple = (), timeout: float = 240.0):
    """A coordinator, then a leader (serving before the workers start, so
    it wins the election), then ``n_workers`` workers, started together,
    then the ready barrier (``_ready_barrier``). ``coord`` / ``ports``
    reuse the ports of an earlier start (a restart on the same dirs);
    ``coord_args`` go to the coordinator (``--data-dir``). Returns (the
    coordinator's port, the nodes' ports, their URLs)."""
    coord = coord or _free_port()
    _spawn(procs, env, tmp, "coordinator",
           ["coordinator", "--listen", f"127.0.0.1:{coord}", *coord_args])
    _wait_until(lambda: socket.create_connection(
        ("127.0.0.1", coord), timeout=1).close() or True, timeout)
    ports = ports or [_free_port() for _ in range(n_workers + 1)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    _spawn(procs, env, tmp, "node0", _serve_args(0, ports[0], coord, tmp))
    _wait_until(lambda: _http_get(urls[0] + "/api/status")
                == b"I am the leader", timeout)
    for i in range(1, len(ports)):
        _spawn(procs, env, tmp, f"node{i}",
               _serve_args(i, ports[i], coord, tmp))
    _ready_barrier(urls, timeout)
    return coord, ports, urls


def _ready_barrier(urls: list, timeout: float = 240.0) -> None:
    """Before any upload: every worker answers ``/worker/index-size`` (the
    poll the leader routes new names by: a worker whose poll fails during
    an upload gets none of it) and ``/api/health``, and the leader lists
    every worker."""
    for u in urls[1:]:
        _wait_until(lambda u=u: int(_http_get(u + "/worker/index-size"))
                    >= 0 and json.loads(_http_get(u + "/api/health"))["ok"],
                    timeout)
    _wait_until(lambda: len(json.loads(
        _http_get(urls[0] + "/api/services"))) == len(urls) - 1, timeout)


def _hold_index_bytes(workers: list, timeout: float = 60.0) -> list[int]:
    """After an upload, before any measured round: every worker holds
    index bytes. Returns each worker's bytes; raises naming the empty
    ones (the leader routed the whole upload past them)."""
    sizes: list[int] = []

    def held():
        sizes[:] = [int(_http_get(u + "/worker/index-size"))
                    for u in workers]
        return all(sizes)
    try:
        _wait_until(held, timeout)
    except AssertionError:
        raise AssertionError(
            f"after the upload a worker holds no index bytes: "
            f"{dict(zip(workers, sizes))}") from None
    return sizes


def _upload(client: _KeepAlive, leader_hp, texts, n_docs: int,
            workers: list) -> float:
    """``/leader/upload-batch`` in groups of 500 from 8 threads, then
    every one of ``workers`` must hold index bytes; the seconds the
    upload took."""
    groups = [[{"name": f"d{i}.txt", "text": texts[i]}
               for i in range(lo, min(lo + 500, n_docs))]
              for lo in range(0, n_docs, 500)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda g: client.post(leader_hp, "/leader/upload-batch",
                                          json.dumps(g).encode()), groups))
    took = time.perf_counter() - t0
    _hold_index_bytes(workers)
    return took


def _fleet_env(device) -> tuple[dict, str]:
    """The nodes' environment (``_node_env``) after the kernel library is
    built here, so no node compiles inside a measured window (the nodes
    load the library this process built)."""
    env, node_dev = _node_env(device)
    if node_dev.startswith("cuda"):
        from tfidf_tpu_torch import kernels
        kernels.build_all()
    return env, node_dev


def _card_processes(serving: int, node_dev: str) -> dict | None:
    """The processes holding a CUDA context (``nvidia-smi``'s compute
    apps) must be the ``serving`` nodes, and this process when it
    initialized CUDA itself: the coordinator, the routers and the load
    generators hold none. None off the card."""
    if not node_dev.startswith("cuda"):
        return None
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()
    torch = sys.modules.get("torch")
    own = bool(torch is not None and torch.cuda.is_initialized())
    if len(apps) != serving + own:
        raise RuntimeError(
            f"{len(apps)} processes on the card, expected {serving} "
            f"serving node(s){' and this one' if own else ''}: the "
            f"coordinator, the routers and the load generators must not "
            f"touch it ({apps})")
    return {"processes": len(apps), "serving_nodes": serving,
            "this_process": own}


def _backend(node_dev: str, launches: list) -> str:
    return (f"leader {node_dev}, workers {node_dev} + {node_dev} (ELL "
            f"kernel launches {launches[0]} + {launches[1]}); coordinator "
            f"and routers on the host")


# --------------------------------------------------------------------------
# overload: zipfian closed-loop load generator at 1x / 2x capacity
# --------------------------------------------------------------------------

OV_DOCS = 20_000
OV_VOCAB = 50_000
OV_AVG_LEN = 60
OV_QUERY_POOL = 2_048       # distinct queries; zipf skew over the pool
OV_ZIPF_S = 1.1             # skew exponent (web-search-like popularity)
OV_TAIL_UNIQUE = 0.3        # share of requests carrying a unique query
OV_CACHE_ENTRIES = 512      # < pool size: sustained misses, LRU churn
OV_BASE_CLIENTS = 8         # closed-loop interactive clients (the "1x")
OV_BULK_CLIENTS = 2         # per-phase bulk-lane clients (X-Priority: bulk)
OV_PHASE_S = 12.0
OV_WARM_S = 6.0             # each warm round's seconds


def _zipf_indices(rng, pool: int, n: int, s: float = OV_ZIPF_S):
    w = 1.0 / np.arange(1, pool + 1) ** s
    return rng.choice(pool, size=n, p=w / w.sum())


# the live histogram's quantile estimate is within one bucket ratio of
# truth (utils/metrics.py's geometry), so the cross-check tolerance is
# TWO ratio steps; the lower bound applies only above the floor, where
# transport and queueing are a small share of the client's latency
_HIST_BUCKET_RATIO = 1.2
_HIST_LOWER_FLOOR_MS = 50.0


def _live_quantile_crosscheck(client_lats_s: list, live_snap: dict
                              ) -> dict:
    """The bench's own p50/p99 (client side, every admitted
    ``/leader/start``) against the front door's live histogram quantiles
    (``leader_search_p50_ms`` / ``_p99_ms``). Raises on disagreement
    beyond bucket resolution: the server cannot see more latency than the
    client did, and above the floor not much less."""
    ls = sorted(client_lats_s)
    if not ls:
        raise RuntimeError("[ov] no admitted latencies to cross-check")
    out = {}
    tol = _HIST_BUCKET_RATIO ** 2
    for label, q in (("p50", 0.5), ("p99", 0.99)):
        client_ms = ls[min(len(ls) - 1, int(len(ls) * q))] * 1e3
        live_ms = float(live_snap.get(f"leader_search_{label}_ms", 0.0))
        lower_checked = client_ms >= _HIST_LOWER_FLOOR_MS
        ok = (live_ms > 0.0 and live_ms <= client_ms * tol
              and (not lower_checked or live_ms >= client_ms / tol))
        out[label] = {"client_ms": round(client_ms, 1),
                      "live_ms": round(live_ms, 1),
                      "lower_bound_checked": lower_checked,
                      "ok": bool(ok)}
    if not all(v["ok"] for v in out.values()):
        raise RuntimeError(
            f"[ov] live histogram quantiles disagree with the bench's "
            f"measured distribution beyond bucket resolution: {out}")
    return out


def bench_overload(rng, autopilot: bool = False,
                   corpus: tuple | None = None, *, n_docs: int = OV_DOCS,
                   vocab: int = OV_VOCAB, avg_len: int = OV_AVG_LEN,
                   query_pool: int = OV_QUERY_POOL,
                   phase_s: float = OV_PHASE_S, warm_s: float = OV_WARM_S,
                   device=None) -> dict:
    """Closed-loop zipfian overload against a ROUTER front door: N
    clients a phase, each posting ``/leader/start`` as fast as replies
    come back, query popularity zipf-skewed over a fixed pool. Phases at
    1x and 2x the saturating concurrency; per phase p50/p99 of ADMITTED
    queries per lane, shed rate (429s / offered), q/s and cache hit rate.
    At 2x the front door sheds explicitly (429 + Retry-After, honoured by
    the clients) instead of queueing without bound.

    ``autopilot=True`` runs the same workload with the hand-tuned
    watermarks removed and the SLO autopilot on at fast cadence; one
    extra 2x warm round and a 1x settle round let its controllers
    converge before the measured phases. The leader and both workers run
    on ``device`` (the card by default)."""
    _device(device)
    if corpus is None:
        t0 = time.perf_counter()
        texts = make_texts(rng, n_docs, vocab, avg_len)
        queries = make_queries(rng, vocab, query_pool)
        log(f"[ov] corpus in {time.perf_counter()-t0:.0f}s")
    else:
        texts, queries = corpus

    env, node_dev = _fleet_env(device)
    env.update({
        # a small scatter batch bounds per-RPC work, so queue depth (the
        # backpressure signal) reflects genuine oversubscription
        "TFIDF_SCATTER_BATCH": "4",
        "TFIDF_RESULT_CACHE_ENTRIES": str(OV_CACHE_ENTRIES),
        "TFIDF_ROUTER_CACHE_ENTRIES": str(OV_CACHE_ENTRIES),
    })
    if autopilot:
        env.update({
            # no hand-tuned watermarks: the operator's envelope only (the
            # SLO, the cadence, a clamp floor scaled to the scatter batch
            # of 4, a decision ring that holds the whole run)
            "TFIDF_AUTOPILOT_ENABLED": "true",
            "TFIDF_AUTOPILOT_INTERVAL_MS": "500",
            "TFIDF_AUTOPILOT_MIN_WINDOW": "8",
            "TFIDF_AUTOPILOT_P99_SLO_MS": "500",
            "TFIDF_AUTOPILOT_QUEUE_FLOOR": "2",
            "TFIDF_AUTOPILOT_RING": "8192",
            "TFIDF_RECONCILE_SWEEP_INTERVAL_S": "0.25",
        })
    else:
        env.update({
            # the hand-tuned constants: one extra batch queued sheds bulk,
            # two shed interactive
            "TFIDF_ADMISSION_QUEUE_HIGH_WATER": "3",
            "TFIDF_ADMISSION_QUEUE_CRITICAL": "8",
        })
    import tempfile
    procs: list = []
    tmp = tempfile.mkdtemp(prefix="bench_ov_")
    log(f"[ov] process logs under {tmp}")
    client = _KeepAlive()
    all_lats: list[float] = []   # every admitted latency, all phases
    try:
        coord, ports, urls = _start_cluster(procs, env, tmp)
        leader_hp = ("127.0.0.1", ports[0])
        ((_, rport),) = _spawn_routers(procs, env, tmp, ["router"], coord)
        front = f"http://127.0.0.1:{rport}"
        front_hp = ("127.0.0.1", rport)

        t0 = time.perf_counter()
        _upload(client, leader_hp, texts, n_docs, urls[1:])
        log(f"[ov] uploaded {n_docs} docs in "
            f"{time.perf_counter()-t0:.0f}s")
        # the router's placement view must cover the corpus before the
        # front door is the measured path
        _wait_until(lambda: client.post_full(
            front_hp, "/leader/start", b"warmup")[0] == 200)

        def metrics():
            return json.loads(_http_get(front + "/api/metrics"))

        def run_phase(mult: int, seconds: float = phase_s,
                      measured: bool = False) -> dict:
            n_inter = OV_BASE_CLIENTS * mult
            n_bulk = OV_BULK_CLIENTS * mult
            lats = {"interactive": [], "bulk": []}
            sheds = {"interactive": [0, 0.0], "bulk": [0, 0.0]}
            errors: list[str] = []
            lock = threading.Lock()
            m0 = metrics()
            stop_at = time.monotonic() + seconds

            def one_client(cid: int, lane: str):
                crng = np.random.default_rng(SEED + 1000 * mult + cid)
                idx = _zipf_indices(crng, query_pool, 4096)
                hdrs_out = {"X-Client-Id": f"ov{lane}{cid}"}
                if lane == "bulk":
                    hdrs_out["X-Priority"] = "bulk"
                i = 0
                while time.monotonic() < stop_at:
                    q = queries[idx[i % len(idx)]]
                    if crng.random() < OV_TAIL_UNIQUE:
                        # a score-neutral OOV nonce: no cache answers it
                        q = f"{q} zztail{mult}x{cid}x{i}"
                    i += 1
                    t1 = time.monotonic()
                    try:
                        status, hdrs, _body = client.post_full(
                            front_hp, "/leader/start", q.encode(),
                            timeout=60.0, headers=hdrs_out)
                    except Exception as e:
                        errors.append(repr(e))
                        return
                    if status == 200:
                        dt = time.monotonic() - t1
                        with lock:
                            lats[lane].append(dt)
                    elif status == 429:
                        ra = min(float(hdrs.get("Retry-After", 0.05)),
                                 0.5)
                        with lock:
                            sheds[lane][0] += 1
                            sheds[lane][1] += ra
                        time.sleep(ra)   # the polite client backs off
                    else:
                        errors.append(f"status {status}")
                        return

            threads = [threading.Thread(target=one_client,
                                        args=(i, "interactive"),
                                        daemon=True)
                       for i in range(n_inter)]
            threads += [threading.Thread(target=one_client,
                                         args=(i, "bulk"), daemon=True)
                        for i in range(n_bulk)]
            with _measured_window(f"overload-{mult}x",
                                  steady_state=measured):
                t1 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=seconds + 120)
                wall = time.perf_counter() - t1
            if errors:
                raise RuntimeError(f"[ov] phase {mult}x client "
                                   f"failures: {errors[:3]}")
            m1 = metrics()

            def lane_stats(lane):
                ls = sorted(lats[lane])
                n = len(ls)
                shed_n, ra_sum = sheds[lane]
                offered = n + shed_n
                return {
                    "admitted": n,
                    "shed": shed_n,
                    "shed_rate": round(shed_n / offered, 4)
                    if offered else 0.0,
                    "qps": round(n / wall, 1),
                    "p50_ms": round(ls[n // 2] * 1e3, 1) if n else 0.0,
                    "p99_ms": round(ls[int(n * 0.99)] * 1e3, 1)
                    if n else 0.0,
                    "mean_retry_after_s": round(ra_sum / shed_n, 3)
                    if shed_n else 0.0,
                }

            all_lats.extend(lats["interactive"])
            all_lats.extend(lats["bulk"])
            hits = m1.get("cache_hits", 0) - m0.get("cache_hits", 0)
            misses = m1.get("cache_misses", 0) - m0.get("cache_misses", 0)
            out = {
                "clients_interactive": n_inter,
                "clients_bulk": n_bulk,
                "interactive": lane_stats("interactive"),
                "bulk": lane_stats("bulk"),
                "cache_hit_rate": round(hits / (hits + misses), 4)
                if (hits + misses) else 0.0,
            }
            it = out["interactive"]
            log(f"[ov] {mult}x ({n_inter}+{n_bulk}b clients): "
                f"{it['qps']} q/s admitted interactive, "
                f"p50 {it['p50_ms']}ms, p99 {it['p99_ms']}ms, "
                f"shed int {it['shed_rate']:.1%} / "
                f"bulk {out['bulk']['shed_rate']:.1%}, "
                f"cache hit {out['cache_hit_rate']:.1%}")
            return out

        # two warm rounds: the first pays each worker's first commit and
        # every batch shape of the arrivals, the second fills the cache
        run_phase(1, seconds=warm_s)
        run_phase(1, seconds=warm_s)
        if autopilot:
            # convergence: one 2x round, then a 1x settle round so the
            # measured 1x baseline does not inherit the overload residue
            run_phase(2, seconds=warm_s)
            run_phase(1, seconds=warm_s)
        one_x = run_phase(1, measured=True)
        two_x = run_phase(2, measured=True)
        m = metrics()
        auto = None
        if autopilot:
            ap = json.loads(_http_get(front + "/api/autopilot"
                                              "?recent=8192"))
            snap = ap["autopilot"]
            dirs_by_knob: dict[str, list[int]] = {}
            for d in ap["decisions"]:
                if d.get("applied") and d["reason"] == "adjusted":
                    dirs_by_knob.setdefault(d["knob"], []).append(
                        d["direction"])
            auto = {
                "enabled": snap["enabled"],
                "p99_slo_ms": snap["p99_slo_ms"],
                "knobs": {k: {"current": v["current"],
                              "static": v["static"],
                              "adjustments": v["adjustments"]}
                          for k, v in snap["knobs"].items()},
                "adjustments_total": sum(
                    v["adjustments"] for v in snap["knobs"].values()),
                # adjacent direction flips among applied adjustments
                "direction_flips": {
                    k: sum(1 for a, b in zip(ds, ds[1:]) if a != b)
                    for k, ds in dirs_by_knob.items()},
            }
            log(f"[ov] autopilot knobs: {auto['knobs']}")
        # the live histogram against the bench's own measurements, while
        # the front door is still up
        hist_check = _live_quantile_crosscheck(all_lats, m)
        log(f"[ov] live-histogram cross-check: {hist_check}")
        card = _card_processes(3, node_dev)
        launches = _worker_launches(urls[1:], node_dev)
        out = {
            "mode": "autopilot" if autopilot else "static",
            "one_x": one_x, "two_x": two_x,
            "live_histogram_check": hist_check,
            "p99_ratio_2x_vs_1x": round(
                two_x["interactive"]["p99_ms"]
                / one_x["interactive"]["p99_ms"], 2)
            if one_x["interactive"]["p99_ms"] else 0.0,
            "n_docs": n_docs, "query_pool": query_pool,
            "zipf_s": OV_ZIPF_S, "tail_unique": OV_TAIL_UNIQUE,
            "cache_entries": OV_CACHE_ENTRIES,
            "phase_s": phase_s, "workers": 2,
            "front_door": "router",
            "shed_total": int(m.get("admission_shed_total", 0)),
            "backend": _backend(node_dev, launches),
            # the router, the coordinator, the nodes' hosts and the client
            # threads share these cores: compare runs at equal host_cpus
            "host_cpus": os.cpu_count(),
            "card_processes": card,
            "worker_kernel_launches": launches,
        }
        if auto is not None:
            out["autopilot"] = auto
        return out
    finally:
        _kill_all(procs)


def overload_main(*, device=None, **sizes) -> None:
    """``--overload`` (artifact ``OVERLOAD.json``): two runs of the same
    closed-loop zipfian workload on one corpus, the hand-tuned static
    watermarks and then the SLO autopilot. The headline is the autopilot
    run's 2x admitted-interactive p99, and its 2x/1x p99 ratio."""
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    vocab = sizes.get("vocab", OV_VOCAB)
    corpus = (make_texts(rng, sizes.get("n_docs", OV_DOCS), vocab,
                         sizes.get("avg_len", OV_AVG_LEN)),
              make_queries(rng, vocab,
                           sizes.get("query_pool", OV_QUERY_POOL)))
    log(f"[ov] corpus in {time.perf_counter()-t0:.0f}s (shared by both "
        f"runs)")
    ov_static = bench_overload(rng, autopilot=False, corpus=corpus,
                               device=device, **sizes)
    ov_auto = bench_overload(rng, autopilot=True, corpus=corpus,
                             device=device, **sizes)
    result = {
        "metric": "overload_2x_admitted_interactive_p99_ms_autopilot",
        "value": ov_auto["two_x"]["interactive"]["p99_ms"],
        "unit": "ms",
        # admitted-interactive p99 at 2x over 1x with the autopilot; on a
        # host whose cores the whole fleet shares the ratio reflects CPU
        # saturation as much as admission: judge it against the static
        # run in the same artifact, on the same host
        "vs_baseline": ov_auto["p99_ratio_2x_vs_1x"],
        "extra": {
            "autopilot": ov_auto,
            "static_hand_tuned": ov_static,
            "p99_ratio_static": ov_static["p99_ratio_2x_vs_1x"],
            "p99_ratio_autopilot": ov_auto["p99_ratio_2x_vs_1x"],
        },
        "device": card_info(),
    }
    headline = {
        "ap_p99_1x_ms": ov_auto["one_x"]["interactive"]["p99_ms"],
        "ap_p99_2x_ms": ov_auto["two_x"]["interactive"]["p99_ms"],
        "ap_p99_ratio": ov_auto["p99_ratio_2x_vs_1x"],
        "static_p99_ratio": ov_static["p99_ratio_2x_vs_1x"],
        "ap_shed_int_2x":
            ov_auto["two_x"]["interactive"]["shed_rate"],
        "ap_qps_2x": ov_auto["two_x"]["interactive"]["qps"],
        "ap_adjustments":
            ov_auto.get("autopilot", {}).get("adjustments_total", 0),
        "ap_direction_flips": sum(
            ov_auto.get("autopilot", {}).get("direction_flips",
                                             {}).values()),
        "cache_hit_rate_2x": ov_auto["two_x"]["cache_hit_rate"],
    }
    _emit_validated(result, headline, name="OVERLOAD.json")


# --------------------------------------------------------------------------
# traffic capture / replay: the durable request log tapped at a router
# --------------------------------------------------------------------------

R10_DOCS = 8_000
R10_VOCAB = 30_000
R10_AVG_LEN = 60
R10_QUERY_POOL = 1_024      # distinct queries; zipf skew over the pool
R10_ZIPF_S = 1.1
R10_TAIL_UNIQUE = 0.15      # unique-query tail no cache can absorb
R10_CACHE = 512
R10_CLIENTS = 8             # measured closed-loop interactive clients
R10_BULK = 2                # measured bulk-lane clients
R10_WARM_S = 5.0
R10_CAPTURE_S = 12.0
R10_REPLAY_SLOTS = 32       # open-loop replay dispatch concurrency


def bench_replay(rng, *, n_docs: int = R10_DOCS, vocab: int = R10_VOCAB,
                 avg_len: int = R10_AVG_LEN,
                 query_pool: int = R10_QUERY_POOL,
                 warm_s: float = R10_WARM_S,
                 capture_s: float = R10_CAPTURE_S,
                 device=None) -> tuple[dict, dict]:
    """Capture, then replay: a zipfian closed-loop workload runs through a
    ROUTER with the capture tap armed (``replay_capture_path``: every
    admitted ``/leader/start`` lands in the CRC-framed request log with
    its arrival offset, lane and client id). The capture router is
    stopped gracefully (the log's flush-on-close contract), the log is
    decoded, and a FRESH router replays it open-loop at the recorded
    offsets, lanes and clients, 429s retried per Retry-After until
    admitted. The fidelity gate: every captured record admitted, none
    invented. Warm-up traffic and readiness probes ride the same tap and
    are replayed, but only the ``r10m-`` clients' latencies count, on
    both sides. The leader and both workers run on ``device``."""
    import tempfile

    from tfidf_tpu_torch.utils.storage import RequestLog

    _device(device)
    t0 = time.perf_counter()
    texts = make_texts(rng, n_docs, vocab, avg_len)
    queries = make_queries(rng, vocab, query_pool)
    log(f"[r10] corpus in {time.perf_counter()-t0:.0f}s")

    env, node_dev = _fleet_env(device)
    env.update({
        "TFIDF_SCATTER_BATCH": "4",
        "TFIDF_RESULT_CACHE_ENTRIES": str(R10_CACHE),
        "TFIDF_ROUTER_CACHE_ENTRIES": str(R10_CACHE),
    })
    procs: list = []
    tmp = tempfile.mkdtemp(prefix="bench_r10_")
    log(f"[r10] process logs under {tmp}")
    cap_path = os.path.join(tmp, "capture", "requests.log")
    client = _KeepAlive()
    try:
        coord, ports, urls = _start_cluster(procs, env, tmp)
        leader_hp = ("127.0.0.1", ports[0])

        def mk_router(capture):
            ((p, rp),) = _spawn_routers(
                procs, env, tmp,
                ["router_capture" if capture else "router_replay"], coord,
                extra_env=({"TFIDF_REPLAY_CAPTURE_PATH": cap_path}
                           if capture else None))
            return p, ("127.0.0.1", rp)

        cap_proc, front_hp = mk_router(capture=True)
        t1 = time.perf_counter()
        _upload(client, leader_hp, texts, n_docs, urls[1:])
        log(f"[r10] uploaded {n_docs} docs in "
            f"{time.perf_counter()-t1:.0f}s")
        _wait_until(lambda: client.post_full(
            front_hp, "/leader/start", b"warmup")[0] == 200)

        # the closed-loop client of the warm and measured rounds; the
        # "r10m-" client-id prefix marks the records whose latencies count
        def one_client(lane, cid, seconds, measured):
            crng = np.random.default_rng(
                SEED + 977 * cid + (1 if lane == "bulk" else 0)
                + (100 if measured else 0))
            idx = _zipf_indices(crng, query_pool, 4096)
            prefix = "r10m-" if measured else "r10warm-"
            hdrs = {"X-Client-Id": f"{prefix}{lane}{cid}"}
            if lane == "bulk":
                hdrs["X-Priority"] = "bulk"
            lats, sheds = [], 0
            stop_at = time.monotonic() + seconds
            i = 0
            while time.monotonic() < stop_at:
                q = queries[idx[i % len(idx)]]
                if crng.random() < R10_TAIL_UNIQUE:
                    q = f"{q} zzr10{lane}{cid}x{i}"
                i += 1
                t2 = time.monotonic()
                status, h, _b = client.post_full(
                    front_hp, "/leader/start", q.encode(),
                    timeout=60.0, headers=hdrs)
                if status == 200:
                    lats.append(time.monotonic() - t2)
                elif status == 429:
                    sheds += 1
                    time.sleep(min(float(h.get("Retry-After", 0.05)),
                                   0.5))
                else:
                    raise RuntimeError(f"[r10] status {status}")
            return lane, lats, sheds

        def round_(seconds, measured):
            with _measured_window(f"replay-capture-{measured}",
                                  steady_state=measured), \
                    concurrent.futures.ThreadPoolExecutor(
                        R10_CLIENTS + R10_BULK) as ex:
                futs = [ex.submit(one_client, "interactive", c,
                                  seconds, measured)
                        for c in range(R10_CLIENTS)]
                futs += [ex.submit(one_client, "bulk", c, seconds,
                                   measured) for c in range(R10_BULK)]
                # each client stops at its deadline; its last request
                # may take up to its 60 s socket timeout
                return [f.result(timeout=seconds + 120.0) for f in futs]

        round_(warm_s, measured=False)   # first commits + the cache head
        res = round_(capture_s, measured=True)
        cap_lats = sorted(ls for lane, lats, _ in res
                          if lane == "interactive" for ls in lats)
        cap_sheds = sum(s for _, _, s in res)
        n = len(cap_lats)
        cap_p50 = cap_lats[n // 2] * 1e3 if n else 0.0
        cap_p99 = cap_lats[int(n * 0.99)] * 1e3 if n else 0.0
        log(f"[r10] capture phase: {n} admitted interactive, "
            f"p50 {cap_p50:.1f}ms p99 {cap_p99:.1f}ms, {cap_sheds} shed")

        # graceful stop: flush-on-close is what makes the tail replayable
        cap_proc.terminate()
        cap_proc.wait(timeout=15)
        entries = RequestLog.read(cap_path)
        if not entries:
            raise RuntimeError("[r10] capture log empty")
        log(f"[r10] captured {len(entries)} admitted requests")

        _r_proc, replay_hp = mk_router(capture=False)
        _wait_until(lambda: client.post_full(
            replay_hp, "/leader/start", b"warmup")[0] == 200)

        # open-loop replay at the recorded offsets; 429s retried until
        # admitted, so the replayed-admitted count is exact
        t_first = entries[0]["t"]
        base = time.monotonic() + 0.5
        lock = threading.Lock()
        stats = {"admitted": 0, "retries_429": 0, "late": 0}
        replay_lats = []

        def replay_one(e):
            due = base + (e["t"] - t_first)
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                with lock:
                    stats["late"] += 1
            hdrs = {"X-Client-Id": e.get("client") or "r10replay"}
            if e.get("lane") == "bulk":
                hdrs["X-Priority"] = "bulk"
            t2 = time.monotonic()
            while True:
                status, h, _b = client.post_full(
                    replay_hp, "/leader/start", e["query"].encode(),
                    timeout=60.0, headers=hdrs)
                if status == 200:
                    break
                if status == 429:
                    with lock:
                        stats["retries_429"] += 1
                    time.sleep(min(float(h.get("Retry-After", 0.05)),
                                   0.5))
                    continue
                raise RuntimeError(f"[r10] replay status {status}")
            dt = time.monotonic() - t2
            with lock:
                stats["admitted"] += 1
                if (e.get("lane") == "interactive"
                        and str(e.get("client", "")).startswith("r10m-")):
                    replay_lats.append(dt)

        with _measured_window("replay", steady_state=True):
            t1 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(
                    R10_REPLAY_SLOTS) as ex:
                list(ex.map(replay_one, entries))
            replay_wall = time.perf_counter() - t1
        rl = sorted(replay_lats)
        rn = len(rl)
        rep_p50 = rl[rn // 2] * 1e3 if rn else 0.0
        rep_p99 = rl[int(rn * 0.99)] * 1e3 if rn else 0.0
        log(f"[r10] replay: {stats['admitted']}/{len(entries)} "
            f"admitted in {replay_wall:.0f}s "
            f"({stats['retries_429']} retried 429s), measured "
            f"interactive p50 {rep_p50:.1f}ms p99 {rep_p99:.1f}ms")

        # the fidelity gate, before any artifact is worth emitting
        fidelity = {
            "captured_records": len(entries),
            "replayed_admitted": stats["admitted"],
            "identical_admitted": stats["admitted"] == len(entries),
            "measured_capture_interactive": n,
            "measured_replay_interactive": rn,
            "replay_retries_429": stats["retries_429"],
            "replay_dispatched_late": stats["late"],
        }
        if not fidelity["identical_admitted"] or rn == 0:
            raise RuntimeError(f"[r10] replay fidelity broken: "
                               f"{fidelity}")
        card = _card_processes(3, node_dev)
        launches = _worker_launches(urls[1:], node_dev)

        result = {
            "metric": "replay_admitted_interactive_p99_ms",
            "value": round(rep_p99, 1),
            "unit": "ms",
            # replayed p99 over the live capture phase's (a cold router
            # cache and open-loop pacing against closed-loop contention:
            # the ratio carries both; not a regression gate)
            "vs_baseline": round(rep_p99 / cap_p99, 2) if cap_p99
            else 0.0,
            "extra": {
                "fidelity": fidelity,
                "capture": {"p50_ms": round(cap_p50, 1),
                            "p99_ms": round(cap_p99, 1),
                            "admitted_interactive": n,
                            "shed": cap_sheds,
                            "phase_s": capture_s,
                            "clients": R10_CLIENTS,
                            "bulk_clients": R10_BULK},
                "replay": {"p50_ms": round(rep_p50, 1),
                           "p99_ms": round(rep_p99, 1),
                           "wall_s": round(replay_wall, 1),
                           "slots": R10_REPLAY_SLOTS},
                "n_docs": n_docs, "query_pool": query_pool,
                "zipf_s": R10_ZIPF_S, "tail_unique": R10_TAIL_UNIQUE,
                "cache_entries": R10_CACHE,
                "front_door": "router",
                "backend": _backend(node_dev, launches),
                # absolute latencies are host-bound; the fidelity block
                # is the portable claim
                "host_cpus": os.cpu_count(),
                "card_processes": card,
                "worker_kernel_launches": launches,
            },
            "device": card_info(),
        }
        headline = {
            "captured": len(entries),
            "replayed_admitted": stats["admitted"],
            "fidelity_identical": fidelity["identical_admitted"],
            "capture_p99_ms": round(cap_p99, 1),
            "replay_p99_ms": round(rep_p99, 1),
            "replay_vs_capture_p99": result["vs_baseline"],
            "replay_retries_429": stats["retries_429"],
        }
        return result, headline
    finally:
        _kill_all(procs)


def replay_main(*, device=None, **sizes) -> None:
    """``--replay`` (artifact ``BENCH_r10.json``): the capture/replay
    bench."""
    rng = np.random.default_rng(SEED)
    result, headline = bench_replay(rng, device=device, **sizes)
    _emit_validated(result, headline, name="BENCH_r10.json")


# --------------------------------------------------------------------------
# router scale-out: admitted q/s through 1/2/4 stateless routers
# --------------------------------------------------------------------------

RT7_DOCS = 4_000
RT7_VOCAB = 30_000
RT7_AVG_LEN = 60
RT7_QUERY_POOL = 512        # distinct queries; zipf skew over the pool
RT7_TAIL_EVERY = 33         # every Nth request carries a unique query (the
#                             backend stays two workers in every phase:
#                             this bench scales the FRONT DOOR)
RT7_CACHE = 2_048           # per-ROUTER result cache (>= pool)
RT7_CLIENT_PROCS = 12       # load-generator PROCESSES: one Python process
#                             cannot load even two routers
RT7_CLIENT_THREADS = 6      # closed-loop connections per process
RT7_WARM_S = 5.0
RT7_PHASE_S = 10.0
RT7_COUNTS = (1, 2, 4)

# the closed-loop client process: threads hammer ONE router over
# keep-alive connections, honouring 429 Retry-After; only the window
# after warm_s is recorded. Run with `python -c` and a JSON spec file: no
# pickling, no fork with threads, no import of the bench (or of torch)
_R7_CLIENT_SRC = r'''
import http.client, json, socket, sys, threading, time
spec = json.load(open(sys.argv[1]))
port, queries = spec["port"], spec["queries"]
warm_end = time.monotonic() + spec["warm_s"]
stop_at = warm_end + spec["measure_s"]
lats, shed, errors = [], [0], []
lock = threading.Lock()

def run(tid, seq):
    conn = None
    i = 0
    while time.monotonic() < stop_at:
        q = queries[seq[i % len(seq)]]
        if spec["tail_every"] and i % spec["tail_every"] == 0:
            q = f"{q} zztail{port}x{tid}x{i}"
        i += 1
        t1 = time.monotonic()
        try:
            if conn is None:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=60)
                conn.connect()
                conn.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
            conn.request("POST", "/leader/start", body=q.encode(),
                         headers={"Content-Type": "text/plain"})
            r = conn.getresponse()
            r.read()
            st, ra = r.status, r.getheader("Retry-After")
            if r.will_close:
                conn.close()
                conn = None
        except Exception as e:
            try:
                conn.close()
            except Exception:
                pass
            conn = None
            errors.append(repr(e))
            return
        t2 = time.monotonic()
        if st == 200:
            if t1 >= warm_end:
                with lock:
                    lats.append(t2 - t1)
        elif st == 429:
            if t1 >= warm_end:
                with lock:
                    shed[0] += 1
            time.sleep(min(float(ra or 0.05), 0.5))
        else:
            errors.append(f"status {st}")
            return

threads = [threading.Thread(target=run, args=(k, s))
           for k, s in enumerate(spec["seqs"])]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"lats": lats, "shed": shed[0],
                  "errors": errors[:3]}))
'''


def bench_routers(rng, corpus: tuple | None = None, *,
                  n_docs: int = RT7_DOCS, vocab: int = RT7_VOCAB,
                  avg_len: int = RT7_AVG_LEN,
                  query_pool: int = RT7_QUERY_POOL,
                  client_procs: int = RT7_CLIENT_PROCS,
                  client_threads: int = RT7_CLIENT_THREADS,
                  warm_s: float = RT7_WARM_S, phase_s: float = RT7_PHASE_S,
                  counts: tuple = RT7_COUNTS, device=None) -> dict:
    """Scale-out query plane: the same zipfian closed-loop interactive
    workload at EQUAL offered load (``client_procs`` x ``client_threads``
    connections) through 1, 2 and 4 router processes in front of one
    2-worker cluster, router results held equal to the leader's before
    any phase is measured. The scaling is reported, not asserted: the
    routers, the load generators and the nodes' hosts share the
    machine's cores. The leader and both workers run on ``device``."""
    import tempfile

    _device(device)
    if corpus is None:
        t0 = time.perf_counter()
        texts = make_texts(rng, n_docs, vocab, avg_len)
        queries = make_queries(rng, vocab, query_pool)
        log(f"[r7] corpus in {time.perf_counter()-t0:.0f}s")
    else:
        texts, queries = corpus

    env, node_dev = _fleet_env(device)
    env.update({
        "TFIDF_ROUTER_CACHE_ENTRIES": str(RT7_CACHE),
        "TFIDF_ROUTER_REFRESH_MS": "500",
    })
    procs: list = []
    tmp = tempfile.mkdtemp(prefix="bench_r7_")
    log(f"[r7] process logs under {tmp}")
    client = _KeepAlive()
    card = None
    try:
        coord, ports, urls = _start_cluster(procs, env, tmp)
        leader_hp = ("127.0.0.1", ports[0])
        ingest_s = _upload(client, leader_hp, texts, n_docs, urls[1:])
        # the ingest path fsyncs before it acknowledges (group commit)
        ingest_dps = round(n_docs / ingest_s, 1)
        log(f"[r7] uploaded {n_docs} docs in {ingest_s:.0f}s "
            f"({ingest_dps} docs/s, fsync-before-ack)")

        def run_phase(n_routers: int) -> dict:
            nonlocal card
            rprocs, rports = map(list, zip(*_spawn_routers(
                procs, env, tmp,
                [f"router{n_routers}_{j}" for j in range(n_routers)],
                coord)))
            rurls = [f"http://127.0.0.1:{p}" for p in rports]
            for u in rurls:
                _wait_until(lambda u=u: json.loads(_http_get(
                    u + "/api/router"))["placement"]["docs"] == n_docs)
            # the correctness gate BEFORE measuring: router results equal
            # the leader's exactly (the same placement world)
            for q in queries[:8]:
                via_leader = json.loads(client.post(
                    leader_hp, "/leader/start", q.encode()))
                for i, p in enumerate(rports):
                    via_router = json.loads(client.post(
                        ("127.0.0.1", p), "/leader/start", q.encode()))
                    if via_router != via_leader:
                        raise RuntimeError(
                            f"[r7] router {i} result diverges from "
                            f"the leader for {q!r}")

            # EQUAL offered load every phase: the same client-process
            # fleet, round-robin over this phase's routers
            cprocs = []
            for c in range(client_procs):
                crng = np.random.default_rng(SEED + 1000 * n_routers + c)
                seqs = [_zipf_indices(crng, query_pool, 4096).tolist()
                        for _ in range(client_threads)]
                spec = {"port": rports[c % n_routers],
                        "queries": queries, "seqs": seqs,
                        "warm_s": warm_s, "measure_s": phase_s,
                        "tail_every": RT7_TAIL_EVERY}
                path = os.path.join(tmp, f"r7c_{n_routers}_{c}.json")
                with open(path, "w", encoding="utf-8") as f:
                    json.dump(spec, f)
                cprocs.append(subprocess.Popen(
                    [sys.executable, "-c", _R7_CLIENT_SRC, path],
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL))
            procs.extend(cprocs)
            lats: list[float] = []
            sheds = 0
            errors: list[str] = []
            with _measured_window(f"routers-{n_routers}",
                                  steady_state=True):
                # mid-window, every process of the phase alive: only the
                # serving nodes hold the card
                time.sleep(warm_s + phase_s / 2)
                card = _card_processes(3, node_dev)
                for p in cprocs:
                    out, _ = p.communicate(timeout=warm_s + phase_s + 120)
                    got = json.loads(out)
                    lats.extend(got["lats"])
                    sheds += got["shed"]
                    errors.extend(got["errors"])
            if errors:
                raise RuntimeError(f"[r7] {n_routers}-router phase "
                                   f"client failures: {errors[:3]}")
            wall = phase_s   # each client records exactly this window
            hit_rates = []
            for u in rurls:
                snap = json.loads(_http_get(u + "/api/router"))
                hit_rates.append(snap["cache"]["hit_rate"])
            _kill_all(rprocs)
            for p in rprocs + cprocs:
                procs.remove(p)
            ls = sorted(lats)
            n = len(ls)
            out = {
                "routers": n_routers,
                "clients": client_procs * client_threads,
                "admitted": n,
                "shed": sheds,
                "admitted_qps": round(n / wall, 1),
                "p50_ms": round(ls[n // 2] * 1e3, 1) if n else 0.0,
                "p99_ms": round(ls[int(n * 0.99)] * 1e3, 1)
                if n else 0.0,
                "cache_hit_rate": round(
                    sum(hit_rates) / len(hit_rates), 4),
            }
            log(f"[r7] {n_routers} router(s): "
                f"{out['admitted_qps']} admitted q/s, "
                f"p50 {out['p50_ms']}ms, p99 {out['p99_ms']}ms, "
                f"cache hit {out['cache_hit_rate']:.1%}, "
                f"shed {out['shed']}")
            return out

        table = {str(r): run_phase(r) for r in counts}
        launches = _worker_launches(urls[1:], node_dev)
        q1 = table["1"]["admitted_qps"]
        return {
            "routers": table,
            "scaling_2r_vs_1r": round(
                table["2"]["admitted_qps"] / q1, 4) if q1 else 0.0,
            "scaling_4r_vs_1r": round(
                table["4"]["admitted_qps"] / q1, 4) if q1 else 0.0,
            "parity_checked": True,
            "n_docs": n_docs, "query_pool": query_pool,
            "zipf_s": OV_ZIPF_S,
            "tail_unique": round(1.0 / RT7_TAIL_EVERY, 3),
            "cache_entries": RT7_CACHE, "phase_s": phase_s,
            "workers": 2,
            "ingest_dps": ingest_dps,
            "fsync_before_ack": True,
            "backend": _backend(node_dev, launches),
            "host_cpus": os.cpu_count(),
            "card_processes": card,
            "worker_kernel_launches": launches,
        }
    finally:
        _kill_all(procs)


def routers_main(*, device=None, **sizes) -> None:
    """``--routers`` (artifact ``BENCH_r07.json``): admitted interactive
    q/s at 2 routers, and its scaling over 1 router at equal offered
    load (reported, not gated: the host's cores are shared)."""
    rng = np.random.default_rng(SEED)
    r7 = bench_routers(rng, device=device, **sizes)
    result = {
        "metric": "router_scaleout_admitted_qps_2r",
        "value": r7["routers"]["2"]["admitted_qps"],
        "unit": "queries/sec",
        "vs_baseline": round(r7["scaling_2r_vs_1r"], 2),
        "extra": r7,
        "device": card_info(),
    }
    headline = {
        "qps_1r": r7["routers"]["1"]["admitted_qps"],
        "qps_2r": r7["routers"]["2"]["admitted_qps"],
        "qps_4r": r7["routers"]["4"]["admitted_qps"],
        "scaling_2r": r7["scaling_2r_vs_1r"],
        "scaling_4r": r7["scaling_4r_vs_1r"],
        "p99_2r_ms": r7["routers"]["2"]["p99_ms"],
        "cache_hit_2r": r7["routers"]["2"]["cache_hit_rate"],
    }
    _emit_validated(result, headline, name="BENCH_r07.json")


# --------------------------------------------------------------------------
# kernel: the ELL kernel's variants on one block; steady commit cost
# --------------------------------------------------------------------------

KB_MESH_SWEEP = (12_500, 25_000, 50_000)   # 4x corpus range
KB_SEG_SWEEP = (12_500, 25_000, 50_000)
KB_VOCAB = 20_000
KB_AVG_LEN = 40
KB_BATCH_DOCS = 500                        # steady-commit batch: the
KB_COMMITS = 8                             # 8-batch total stays under
                                           # delta_rebuild_frac x the
                                           # smallest base corpus, so no
                                           # planned fold lands in the
                                           # steady window either
KB_SCORING_VOCABS = (30_000, 200_000)      # the reference's packed / plain
                                           # v4 cases


def make_case(rng, *, rows_cap, width, n_rows, B, n_terms, u_req,
              vocab=500_000, ragged=False, device=None):
    """Random ELL block + query batch, the draws of the reference's
    ``kernel_parity.make_case``. Term ids are DISTINCT within each row
    (position w draws from the congruence class w mod width); pad rows
    (>= n_rows) are zeroed like the real build; ``ragged`` also zeroes a
    random per-row tail; the slot capacity is driven via min_slots. The
    batch is on ``device``."""
    from tfidf_tpu_torch.ops.scoring import make_query_batch
    slots = max(vocab // width, 1)
    base = rng.integers(0, slots, size=(rows_cap, width))
    term = (base * width
            + np.arange(width, dtype=np.int64)[None, :]).astype(np.int32)
    imp = rng.random((rows_cap, width), dtype=np.float32)
    if ragged:
        fill = rng.integers(1, width + 1, size=(rows_cap, 1))
        dead = np.arange(width)[None, :] >= fill
        term[dead] = 0
        imp[dead] = 0.0
    term[n_rows:] = 0
    imp[n_rows:] = 0.0
    # queries draw from the same vocab so some terms hit
    q_terms = np.zeros((B, 8), np.int32)
    q_weights = np.zeros((B, 8), np.float32)
    for i in range(B):
        k = rng.integers(1, 5)
        ids = rng.integers(0, vocab, size=k)
        # seed a few query terms from the block so scores are non-zero
        if i % 3 == 0:
            ids[0] = term[rng.integers(0, max(n_rows, 1)),
                          rng.integers(0, width)]
        q_terms[i, :k] = ids
        q_weights[i, :k] = 1.0 + rng.random(k, dtype=np.float32)
    qb = make_query_batch(q_terms, q_weights, min_slots=u_req,
                          device=device)
    return imp, term, qb


def kernel_cost_model() -> dict:
    """The reference's A-build op-count model for the TPU kernel: vector
    register operations per padded entry per unique-term lane (v3: one
    compare, one select, one accumulate add; v4 folds a row pair into one
    add; the packed sub-variant halves the compares with i16 lanes). A
    model of the TPU's vector unit, kept for the record: it is NOT a
    number of the card, whose kernel the artifact measures instead (the
    v3/v4 ratio and each variant's share of its bound)."""
    v3 = {"compare": 1.0, "select": 1.0, "accumulate_add": 1.0}
    v4 = {"compare": 1.0, "select": 1.0, "accumulate_add": 0.5}
    v4p = {"compare": 0.5, "select": 1.0, "accumulate_add": 0.5}
    return {
        "unit": "tpu_vreg_ops_per_padded_entry_per_uniq_lane",
        "scaling": "total = per_entry x nnz_padded x ceil(U/TU)*TU",
        "v3": v3, "v3_total": sum(v3.values()),
        "v4": v4, "v4_total": sum(v4.values()),
        "v4_packed": v4p, "v4_packed_total": sum(v4p.values()),
        "v4_ratio": round(sum(v3.values()) / sum(v4.values()), 3),
        "v4_packed_ratio": round(
            sum(v3.values()) / sum(v4p.values()), 3),
        "halved_components": {
            "accumulate_adds_per_entry": [1.0, 0.5],
            "compare_vregs_per_entry_packed": [1.0, 0.5],
        },
        "note": "the TPU kernel's model (tfidf_tpu/ops/ell.py), not a "
                "measurement of the CUDA kernel",
    }


def block_bound(imp_t, term_t, slot_of, qc_t, n_rows: int) -> dict:
    """The least time the card could score the block in: the bytes the
    function must move (the live rows' postings read once, their scores
    written once, ``slot_of`` and ``qc_t`` read once) at the HBM rate,
    and one multiply and one add per hit (a posting with a query term's
    slot and a non-zero impact) and query whose weight at that slot is
    not zero, at the f32 rate outside the tensor cores (unfused); the
    larger of the two."""
    W = imp_t.shape[0]
    u1, B = qc_t.shape
    qnnz = (qc_t != 0).sum(1)
    s = slot_of[term_t[:, :n_rows].long()].long()
    hit = imp_t[:, :n_rows] != 0
    ops = 2 * int(qnnz[s].masked_fill(~hit, 0).sum())
    nbytes = (8 * W * n_rows + 4 * B * n_rows + 4 * slot_of.numel()
              + 4 * u1 * B)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_UNFUSED_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _block_csr(imp_t, term_t, slot_of, u1: int, n_rows: int):
    """The block as a CSR matrix A[row, slot], so ``torch.sparse.mm(A,
    qc_t)`` computes the same scores (built outside any timed window)."""
    import torch
    W, rows_cap = imp_t.shape
    d = torch.arange(rows_cap, device=imp_t.device).expand(W, rows_cap)
    s = slot_of[term_t.long()].long()
    keep = (s != u1 - 1) & (d < n_rows)
    A = torch.sparse_coo_tensor(
        torch.stack([d[keep], s[keep]]), imp_t[keep],
        size=(rows_cap, u1)).coalesce()
    return A.to_sparse_csr()


def bench_kernel_scoring(rng, *, vocabs: tuple = KB_SCORING_VOCABS,
                         reps: int = 10, device=None) -> dict:
    """One eligible ELL block at the reference's case shapes through the
    CUDA kernel's two variants (``csrc/ell_score.cu``, STEP=1 and 2), its
    plain version ``score_block_plain`` and ``torch.sparse.mm`` on the
    same inputs. Gated before any number leaves: v3 == v4 == plain, bit
    for bit, the top-k identical, and the library within 1e-4 of plain
    (it adds in another order). The ms are CUDA events on the card (the
    host clock with ``device="cpu"``, where the wrapper runs the plain
    version), beside the block's bound as ``chip_smoke.py`` computes
    it."""
    import torch

    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.ops.scoring import _compile_queries

    dev = _device(device)
    out = {"backend": _device_name(dev),
           "nvcc_compiled": dev.type == "cuda",
           "cases": []}
    for vocab in vocabs:
        kw = dict(rows_cap=2048, width=64, n_rows=1900, B=256,
                  n_terms=4, u_req=512, vocab=vocab)
        imp, term, qb = make_case(rng, device=dev, **kw)
        n_rows, B = kw["n_rows"], kw["B"]
        imp_t = torch.from_numpy(np.ascontiguousarray(imp.T)).to(dev)
        term_t = torch.from_numpy(np.ascontiguousarray(term.T)).to(dev)
        slot_of, qc_ext = _compile_queries(qb, vocab)
        qc_t = qc_ext.T.contiguous()
        u1 = qc_t.shape[0]
        for a in E.A_BUILD_VARIANTS:
            assert E._pallas_eligible(kw["rows_cap"], B, u1 - 1, a), \
                (vocab, a)
        outs = {a: torch.zeros((B, kw["rows_cap"]), dtype=torch.float32,
                               device=dev) for a in E.A_BUILD_VARIANTS}

        def kernel(a):
            return E.score_block_kernel(imp_t, term_t, slot_of, qc_t,
                                        n_rows, out=outs[a], a_build=a)

        A = _block_csr(imp_t, term_t, slot_of, u1, n_rows)
        ref = E.score_block_plain(imp_t, term_t, slot_of, qc_t, n_rows)
        runs = {
            "plain_ms": _ms(lambda: E.score_block_plain(
                imp_t, term_t, slot_of, qc_t, n_rows), dev,
                reps=max(1, reps // 3), warm=False),
            "v3_ms": _ms(lambda: kernel("v3"), dev, reps=reps),
            "v4_ms": _ms(lambda: kernel("v4"), dev, reps=reps),
            "library_ms": _ms(lambda: torch.sparse.mm(A, qc_t), dev,
                              reps=reps),
        }
        # the gate, before any number leaves this function: each
        # variant's output is its last timed launch's
        v3, v4 = outs["v3"], outs["v4"]
        lib = torch.sparse.mm(A, qc_t).T
        _sync(dev)
        if not (torch.equal(v3, v4) and torch.equal(v4, ref)):
            raise RuntimeError(
                f"[kb] vocab {vocab}: v3 == v4 == plain bitwise failed "
                f"(max |v4 - plain| {float((v4 - ref).abs().max())}, "
                f"max |v3 - v4| {float((v3 - v4).abs().max())})")
        ref_h, v4_h = _host(ref), _host(v4)
        max_abs = float(np.max(np.abs(v4_h - ref_h)))
        lib_abs = float((lib - ref).abs().max())
        if lib_abs >= 1e-4:
            raise RuntimeError(f"[kb] vocab {vocab}: torch.sparse.mm is "
                               f"{lib_abs} from plain")
        t_ref = np.argsort(-ref_h, axis=1, kind="stable")[:, :TOP_K]
        t_v4 = np.argsort(-v4_h, axis=1, kind="stable")[:, :TOP_K]
        if not (t_ref == t_v4).all():
            raise RuntimeError(f"[kb] vocab {vocab}: top-k drifted from "
                               f"the plain version")
        bound = block_bound(imp_t, term_t, slot_of, qc_t, n_rows)
        out["cases"].append({
            **kw,
            "packed": vocab <= (1 << 15),
            "max_abs_delta_vs_plain": max_abs,
            "v3_v4_bitwise_equal": True,
            "v4_plain_bitwise_equal": True,
            "topk_identical": True,
            **runs,
            "v3_over_v4": round(runs["v3_ms"]
                                / max(runs["v4_ms"], 1e-9), 3),
            "library_max_abs_delta": lib_abs,
            **bound,
            "v4_share_of_bound": round(bound["bound_ms"]
                                       / max(runs["v4_ms"], 1e-9), 4),
        })
        log(f"[kb] scoring vocab={vocab}: " + " ".join(
            f"{k}={v:.3f}ms" for k, v in runs.items())
            + f" bound={bound['bound_ms']:.4f}ms ({bound['bound_by']})")
    return out


def _kb_commit_sweep(rng, make_index, sweep, *, settle=None,
                     vocab: int = KB_VOCAB, avg_len: int = KB_AVG_LEN,
                     batch_docs: int = KB_BATCH_DOCS,
                     commits: int = KB_COMMITS) -> dict:
    """Steady-commit timing: a base corpus, then ``commits`` batches of
    ``batch_docs`` each, committed and timed, for the incremental path
    and the full-recompute control. Per-size p50s and the witness deltas
    (zero on the incremental path: the callers assert it)."""
    out = {"sweep_docs": list(sweep), "batch_docs": batch_docs,
           "commits": commits, "incremental": {}, "control": {}}
    for label, df_incremental in (("incremental", True),
                                  ("control", False)):
        for n_docs in sweep:
            engine = make_index(df_incremental, n_docs)
            offsets, ids, tfs, lengths = make_doc_arrays(
                rng, n_docs + (commits + 1) * batch_docs, vocab, avg_len)
            add = engine.index.add_document_arrays
            for i in range(n_docs):
                lo, hi = offsets[i], offsets[i + 1]
                add(f"d{i}", ids[lo:hi], tfs[lo:hi], float(lengths[i]))
            engine.commit()
            if settle is not None:
                settle(engine)
            # one warm-up append commit before the timed window: the mesh
            # index promotes its floor delta on the first append burst
            for i in range(n_docs, n_docs + batch_docs):
                lo, hi = offsets[i], offsets[i + 1]
                add(f"d{i}", ids[lo:hi], tfs[lo:hi], float(lengths[i]))
            engine.commit()
            w0 = engine.index.df_full_recomputes
            times = []
            done = n_docs + batch_docs
            with _measured_window(f"kb-{label}-{n_docs}",
                                  steady_state=True):
                for _c in range(commits):
                    for i in range(done, done + batch_docs):
                        lo, hi = offsets[i], offsets[i + 1]
                        add(f"d{i}", ids[lo:hi], tfs[lo:hi],
                            float(lengths[i]))
                    done += batch_docs
                    t0 = time.perf_counter()
                    engine.commit()
                    times.append((time.perf_counter() - t0) * 1e3)
            p50 = float(np.percentile(np.asarray(times), 50))
            out[label][str(n_docs)] = {
                "commit_ms_p50": round(p50, 1),
                "commit_ms_max": round(max(times), 1),
                "witness_delta":
                    engine.index.df_full_recomputes - w0,
            }
            log(f"[kb] {label} {n_docs} docs: commit p50 "
                f"{p50:.1f}ms witness_delta="
                f"{engine.index.df_full_recomputes - w0}")
            # only the LARGEST incremental engine is used afterwards
            if label == "incremental" and n_docs == max(sweep):
                out["_engine"] = engine
            del engine
    return out


def bench_segment_commits(rng, *, sweep: tuple = KB_SEG_SWEEP,
                          device=None, **kw) -> dict:
    dev = _device(device)

    def make_index(df_incremental, _n):
        engine = _engine(dev, index_mode="segments", query_batch=8,
                         df_incremental=df_incremental)
        for i in range(kw.get("vocab", KB_VOCAB)):
            engine.vocab.add(f"t{i}")
        return engine

    def settle(engine):
        engine.index.wait_for_merges()
        engine.commit()

    out = _kb_commit_sweep(rng, make_index, sweep, settle=settle, **kw)
    for n_docs, rec in out["incremental"].items():
        if rec["witness_delta"] != 0:
            raise RuntimeError(f"segments steady commits recomputed df "
                               f"at {n_docs} docs")
    eng = out.pop("_engine")
    snap = eng.index.snapshot
    df_o, count_o, _len_o, _live = eng.index._stats_scratch_locked(
        snap.df.shape[0])
    np.testing.assert_array_equal(_host(snap.df), df_o)
    if float(_host(snap.n_docs)) != float(count_o):
        raise RuntimeError("segments sweep engine: n_docs != the "
                           "recompute's")
    hits = eng.search_batch([f"t{i} t{i+7}" for i in range(8)], k=5)
    if not any(hits):
        raise RuntimeError("segments sweep engine failed the search gate")
    out["df_parity_exact"] = True
    out["search_ok"] = True
    return out


def bench_mesh_commits(rng, *, sweep: tuple = KB_MESH_SWEEP, device=None,
                       **kw) -> dict:
    """Steady mesh-ELL commit cost, the incremental journal against the
    O(corpus nnz) recompute control, on the default mesh (every visible
    card on the docs axis: (1, 1) on one card), plus a small serving
    check."""
    dev = _device(device)
    vocab = kw.get("vocab", KB_VOCAB)

    def make_index(df_incremental, _n):
        engine = _engine(dev, engine_mode="mesh", query_batch=32,
                         df_incremental=df_incremental)
        for i in range(vocab):
            engine.vocab.add(f"t{i}")
        return engine

    out = _kb_commit_sweep(rng, make_index, sweep, **kw)
    out["backend"] = _device_name(dev)
    for n_docs, rec in out["incremental"].items():
        if rec["witness_delta"] != 0:
            raise RuntimeError(f"mesh steady commits recomputed df at "
                               f"{n_docs} docs")
    eng = out.pop("_engine")               # the largest-corpus engine
    # exactly TWO rebuilds: the base build and the warm-up commit's
    # one-time delta promotion, none inside the steady window
    if eng.index.rebuilds != 2:
        raise RuntimeError(f"mesh sweep engine: {eng.index.rebuilds} "
                           f"rebuilds, expected 2")
    cap = eng.vocab.capacity()
    inc = eng.index._live_stats(cap)
    scr = eng.index._live_stats_scratch(cap)
    np.testing.assert_array_equal(inc[0], scr[0])
    if inc[1] != scr[1]:
        raise RuntimeError("mesh sweep engine: live count != the "
                           "recompute's")
    snap = eng.index.snapshot
    np.testing.assert_array_equal(_host(snap.df_g)[:cap], scr[0][:cap])
    out["df_parity_exact"] = True
    # the serving gate and a small q/s control (1 warm + 2 timed chunks)
    queries = make_queries(rng, vocab, 128)
    eng.search_batch(queries[:32], k=TOP_K)
    with _measured_window("kb-mesh-serving", steady_state=True):
        t0 = time.perf_counter()
        hits = eng.search_batch(queries[32:96], k=TOP_K)
        qps = 64 / (time.perf_counter() - t0)
    if not any(hits):
        raise RuntimeError("mesh sweep engine failed the search gate")
    out["search_ok"] = True
    out["serving_qps_control"] = round(qps, 1)
    return out


def kernel_main(*, device=None, seg_sweep: tuple = KB_SEG_SWEEP,
                mesh_sweep: tuple = KB_MESH_SWEEP, reps: int = 10,
                vocabs: tuple = KB_SCORING_VOCABS, **sizes) -> None:
    """``--kernel`` (artifact ``BENCH_r09.json``). The headline is the
    card's measured v3/v4 time ratio on the first case, and
    ``vs_baseline`` v4's share of the block's bound (bound ms / v4 ms).
    The reference's TPU op-count model rides in the artifact as a record
    of the TPU kernel only. Gates: v3 == v4 == plain bitwise, the commit
    witnesses at zero, two mesh rebuilds, and the incremental mesh commit
    flat within 2.5x over the 4x corpus sweep."""
    rng = np.random.default_rng(SEED)
    dev = _device(device)
    backend = _device_name(dev)
    scoring = bench_kernel_scoring(rng, vocabs=vocabs, reps=reps,
                                   device=dev)
    cost = kernel_cost_model()
    seg = bench_segment_commits(rng, sweep=seg_sweep, device=dev, **sizes)
    mesh = bench_mesh_commits(rng, sweep=mesh_sweep, device=dev, **sizes)

    def p50s(block):
        return {n: rec["commit_ms_p50"]
                for n, rec in block.items()
                if isinstance(rec, dict) and "commit_ms_p50" in rec}
    mesh_inc = p50s(mesh["incremental"])
    mesh_ctl = p50s(mesh["control"])
    lo, hi = str(min(mesh_sweep)), str(max(mesh_sweep))
    seg_hi = str(max(seg_sweep))
    # steady mesh commits independent of corpus size across the sweep,
    # while the control's recompute grows with the corpus
    flat_ratio = mesh_inc[hi] / max(mesh_inc[lo], 1e-9)
    if not flat_ratio < 2.5:
        raise RuntimeError(f"incremental mesh commit grew "
                           f"{flat_ratio:.2f}x over the sweep")
    case0 = scoring["cases"][0]
    result = {
        "metric": "ell_kernel_v3_over_v4_ms_ratio",
        "value": case0["v3_over_v4"],
        "unit": "x",
        "vs_baseline": case0["v4_share_of_bound"],
        "extra": {
            "backend": backend,
            "a_build_cost_model": cost,
            "kernel_scoring": scoring,
            "segments_commit_sweep": seg,
            "mesh_commit_sweep": mesh,
            "mesh_commit_p50_old_vs_new_ms": {
                "corpus_docs": int(hi),
                "old_full_recompute": mesh_ctl[hi],
                "new_incremental": mesh_inc[hi],
                "old_over_new": round(
                    mesh_ctl[hi] / max(mesh_inc[hi], 1e-9), 2),
            },
            "mesh_commit_flat_ratio_4x": round(flat_ratio, 3),
            "witness_steady_deltas_all_zero": True,
            "hardware_note": "kernel_scoring is measured on this run's "
                             "device; a_build_cost_model is the TPU "
                             "kernel's op-count model, not the card's",
        },
        "device": card_info(),
    }
    headline = {
        "v3_over_v4": case0["v3_over_v4"],
        "v4_ms": case0["v4_ms"],
        "v4_share_of_bound": case0["v4_share_of_bound"],
        "library_ms": case0["library_ms"],
        "mesh_commit_p50_old_ms": mesh_ctl[hi],
        "mesh_commit_p50_new_ms": mesh_inc[hi],
        "mesh_commit_flat_ratio_4x": round(flat_ratio, 3),
        "seg_commit_p50_new_ms":
            seg["incremental"][seg_hi]["commit_ms_p50"],
        "backend": backend,
    }
    _emit_validated(result, headline, name="BENCH_r09.json")


# --------------------------------------------------------------------------
# hybrid retrieval: the dense plane beside the sparse one
# --------------------------------------------------------------------------

HY_DOCS = 20_000
HY_AVG_LEN = 60
HY_BATCH = 256
HY_BATCHES = 4
HY_REL_QUERIES = 200


def bench_hybrid(rng, *, n_docs: int = HY_DOCS, avg_len: int = HY_AVG_LEN,
                 batch: int = HY_BATCH, batches: int = HY_BATCHES,
                 rel_queries: int = HY_REL_QUERIES, device=None) -> dict:
    """Batched dense q/s with the achieved model-flop rate, a sparse /
    dense / hybrid latency table on the SAME engine and query stream, and
    fused-vs-sparse relevance (MRR@10, recall@10 of a known target
    passage) over ``textgen`` passages. Fusion goes through
    ``cluster/fusion.py``."""
    from tfidf_tpu_torch.cluster import fusion
    from tfidf_tpu_torch.utils.textgen import (RealisticCorpus,
                                               harvest_lexicon)

    dev = _device(device)
    t0 = time.perf_counter()
    words, _ = harvest_lexicon()
    gen = RealisticCorpus(rng, words)
    texts = [gen.make_text(avg_len) for _ in range(n_docs)]
    log(f"[hy] {n_docs} passage docs from a {len(words)}-word "
        f"lexicon in {time.perf_counter()-t0:.0f}s")

    # dim 256 (the default is 64): the hash projection's distortion of
    # the bag cosine shrinks ~1/sqrt(dim), and relevance is the point
    engine = _engine(dev, query_batch=batch, embedding_dim=256)
    cfg = engine.config
    t0 = time.perf_counter()
    for i, text in enumerate(texts):
        engine.ingest_text(f"d{i}.txt", text)
    engine.commit()
    log(f"[hy] ingest+commit (sparse + {cfg.embedding_dim}-dim "
        f"embedding column) in {time.perf_counter()-t0:.1f}s")

    def make_query() -> str:
        k = int(rng.integers(2, 5))
        idx = rng.choice(len(words), size=k, p=gen.p)
        return " ".join(words[i] for i in idx)

    queries = [make_query() for _ in range(batch * (batches + 2))]
    stream = queries[2 * batch:]

    def fused_lists(qs, method):
        sp_hits = engine.search_batch(qs, k=TOP_K)
        dn_hits = engine.search_dense_batch(qs, k=TOP_K)
        out = []
        for sh, dh in zip(sp_hits, dn_hits):
            merged = fusion.fuse(
                {h.name: h.score for h in sh}, dict(dh),
                method=method, k=TOP_K, rrf_k=cfg.fusion_rrf_k,
                w_sparse=cfg.fusion_weight_sparse,
                w_dense=cfg.fusion_weight_dense)
            out.append(fusion.rank_list(merged, TOP_K))
        return out

    # warm every path (the sparse kernel, the dense products) off the clock
    engine.search_batch(queries[:batch], k=TOP_K)
    engine.search_dense_batch(queries[:batch], k=TOP_K)
    fused_lists(queries[batch:2 * batch], "rrf")

    def timed(name, run):
        lats = []
        with _measured_window(f"hybrid-{name}", steady_state=True):
            for b in range(batches):
                chunk = stream[b * batch:(b + 1) * batch]
                t = time.perf_counter()
                run(chunk)
                lats.append(time.perf_counter() - t)
        n = batch * batches
        return {"qps": round(n / sum(lats), 1),
                "batch_ms_p50": round(
                    float(np.median(lats)) * 1e3, 2),
                "per_query_us": round(sum(lats) / n * 1e6, 1)}

    lat_sparse = timed("sparse", lambda b: engine.search_batch(b, k=TOP_K))
    lat_dense = timed("dense",
                      lambda b: engine.search_dense_batch(b, k=TOP_K))
    lat_hybrid = timed("hybrid", lambda b: fused_lists(b, "rrf"))
    # achieved matmul rate from MODEL flops (2 * B * live docs * dim:
    # padding excluded, so the number cannot flatter the kernel)
    dim = cfg.embedding_dim
    flops_q = 2.0 * n_docs * dim
    gflops = lat_dense["qps"] * flops_q / 1e9
    log(f"[hy] sparse {lat_sparse['qps']} q/s, dense "
        f"{lat_dense['qps']} q/s ({gflops:.2f} GFLOP/s model flops), "
        f"hybrid {lat_hybrid['qps']} q/s (batch={batch})")

    # relevance on queries with a KNOWN target doc: 3-4 tokens sampled
    # from one passage; the target's reciprocal rank in the top-10
    # (MRR@10) and its hit rate (recall@10)
    def relevance(run_lists) -> tuple:
        mrr = hits = 0.0
        for qi, (q, want) in enumerate(rel_qs):
            ranked = rel_results[run_lists][qi]
            names = [n for n, _ in ranked[:TOP_K]]
            if want in names:
                hits += 1.0
                mrr += 1.0 / (names.index(want) + 1)
        n = len(rel_qs)
        return round(mrr / n, 4), round(hits / n, 4)

    rel_qs = []
    doc_ids = rng.choice(n_docs, size=rel_queries, replace=False)
    for d in doc_ids:
        toks = [t for t in texts[int(d)].split() if len(t) > 3][:40]
        if len(toks) < 4:
            continue
        pick = rng.choice(len(toks), size=int(rng.integers(3, 5)),
                          replace=False)
        rel_qs.append((" ".join(toks[i] for i in pick), f"d{int(d)}.txt"))
    qs = [q for q, _ in rel_qs]
    rel_results = {
        "sparse": [[(h.name, h.score) for h in hs]
                   for hs in engine.search_batch(qs, k=TOP_K)],
        "dense": engine.search_dense_batch(qs, k=TOP_K),
        "hybrid_rrf": fused_lists(qs, "rrf"),
        "hybrid_wsum": fused_lists(qs, "wsum"),
    }
    rel = {mode: {"mrr_at_10": m, "recall_at_10": r}
           for mode, (m, r) in
           ((mode, relevance(mode)) for mode in rel_results)}
    log(f"[hy] relevance over {len(rel_qs)} known-target queries: "
        + ", ".join(f"{m} mrr={v['mrr_at_10']}" for m, v in rel.items()))

    return {
        "docs": n_docs, "batch": batch, "top_k": TOP_K,
        "embedding": engine.dense_stats(),
        "latency": {"sparse": lat_sparse, "dense": lat_dense,
                    "hybrid_rrf": lat_hybrid},
        "dense_model_gflops_per_s": round(gflops, 3),
        "relevance": rel,
        "relevance_queries": len(rel_qs),
        "backend": _device_name(dev),
        # MRR depends on the machine's lexicon: its size and digest
        "lexicon": lexicon_info(),
    }


def hybrid_main(*, device=None, **sizes) -> None:
    """``--hybrid`` (artifact ``BENCH_r11.json``): the headline is the
    batched dense q/s; ``vs_baseline`` dense q/s over sparse q/s on the
    same engine and stream."""
    rng = np.random.default_rng(SEED)
    hy = bench_hybrid(rng, device=device, **sizes)
    result = {
        "metric": "hybrid_dense_batched_qps_20k_docs",
        "value": hy["latency"]["dense"]["qps"],
        "unit": "queries/sec",
        "vs_baseline": round(hy["latency"]["dense"]["qps"]
                             / hy["latency"]["sparse"]["qps"], 3),
        "extra": hy,
        "device": card_info(),
    }
    headline = {
        "dense_qps": hy["latency"]["dense"]["qps"],
        "sparse_qps": hy["latency"]["sparse"]["qps"],
        "hybrid_qps": hy["latency"]["hybrid_rrf"]["qps"],
        "dense_model_gflops_per_s": hy["dense_model_gflops_per_s"],
        "mrr_sparse": hy["relevance"]["sparse"]["mrr_at_10"],
        "mrr_dense": hy["relevance"]["dense"]["mrr_at_10"],
        "mrr_hybrid_rrf":
            hy["relevance"]["hybrid_rrf"]["mrr_at_10"],
        "mrr_hybrid_wsum":
            hy["relevance"]["hybrid_wsum"]["mrr_at_10"],
        "backend": hy["backend"],
    }
    _emit_validated(result, headline, name="BENCH_r11.json")


# --------------------------------------------------------------------------
# tiered postings: a corpus past the hot budget through the tier ring
# --------------------------------------------------------------------------

TI_DOCS = int(os.environ.get("TIER_DOCS", 30_000_000))
TI_PHASE = int(os.environ.get("TIER_PHASE", 1_000_000))
TI_HEAD = 20_000     # shared zipfian head vocabulary
TI_SLICE = 6_000     # per-phase discriminative slice
TI_HEAD_LEN = 6      # head tokens per doc (zipf over TI_HEAD)
TI_SLICE_LEN = 2     # slice tokens per doc (zipf over the phase slice)
TI_BUDGET_MB = int(os.environ.get("TIER_BUDGET_MB", 256))
TI_QUERIES = 64
TI_QBATCH = 8        # dispatch chunk: a segment skips only when provably
                     # useless for EVERY query of the chunk, so the unit
                     # is small homogeneous chunks (discriminative tail
                     # queries)
TI_K = 10


def _tier_phase_corpus(rng, phase: int, n_docs: int):
    """One phase's docs: a zipfian head part and a zipfian slice part,
    each from :func:`make_doc_arrays`, merged per doc. Slice ids sit above
    the head block (every slice id exceeds every head id, so per-doc
    concatenation keeps ``add_document_arrays``' sorted-unique
    contract)."""
    off_h, ids_h, tfs_h, len_h = make_doc_arrays(
        rng, n_docs, TI_HEAD, TI_HEAD_LEN)
    off_s, ids_s, tfs_s, len_s = make_doc_arrays(
        rng, n_docs, TI_SLICE, TI_SLICE_LEN)
    ids_s = (ids_s.astype(np.int64)
             + TI_HEAD + phase * TI_SLICE).astype(np.int32)
    return (off_h, ids_h, tfs_h, len_h), (off_s, ids_s, tfs_s, len_s)


def _tier_queries(rng, phase: int) -> list[str]:
    """Zipfian discriminative queries in ``TI_QBATCH`` chunks: each draws
    2-3 slice terms from a zipfian-recency phase (recent slices queried
    most). The LAST chunk also carries a zipfian head term per query, so
    it can skip only through a genuine MAXSCORE threshold cut."""
    qs = []
    n_chunks = TI_QUERIES // TI_QBATCH
    for c in range(n_chunks):
        for _ in range(TI_QBATCH):
            back = min(int(rng.zipf(1.5)) - 1, phase)
            p = phase - back
            terms = [f"t{TI_HEAD + p * TI_SLICE + int(rng.zipf(1.25) % TI_SLICE)}"
                     for _ in range(int(rng.integers(2, 4)))]
            if c == n_chunks - 1:
                terms.append(f"t{int(rng.zipf(1.25) % TI_HEAD)}")
            qs.append(" ".join(terms))
    return qs


def _gate_failed(msg: str) -> None:
    print(f"BENCH GATE FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bench_tier(rng, *, n_docs: int = TI_DOCS, phase_docs: int = TI_PHASE,
               budget_mb: int = TI_BUDGET_MB, device=None) -> dict:
    """A time-drifting corpus in ``phase_docs`` phases (a commit each, a
    segment each), tiered under a ``budget_mb`` hot budget: each phase's
    query chunks timed through the tiered dispatch (skip stats), then two
    chunks (one pure-slice, the mixed one) through the ``tier_bypass``
    oracle that scores everything, which must give the same top-k to the
    bit. Gates, all before the artifact: the corpus's device bytes exceed
    the budget, the cumulative cold-segment skip rate is above 0.5,
    ``df_full_recomputes`` stays at its first commit's 1, and ingest does
    not decay below half its first phase's rate. On the card it is the
    budget, not the card's memory, that makes the corpus cold: the
    artifact states both."""
    import shutil
    import tempfile

    dev = _device(device)
    n_phases = max(1, n_docs // phase_docs)
    work = tempfile.mkdtemp(prefix="bench_tier_")
    # max_segments > n_phases: the segment IS the tiering and skipping
    # unit here; the dense plane off (the arrays path bypasses the text
    # pipeline it rides)
    engine = _engine(dev, index_mode="segments", query_batch=TI_QBATCH,
                     index_path=os.path.join(work, "index"),
                     tier_enabled=True, tier_hot_budget_mb=budget_mb,
                     max_segments=max(64, n_phases + 2),
                     embedding_enabled=False)
    try:
        t0 = time.perf_counter()
        for i in range(TI_HEAD + n_phases * TI_SLICE):
            engine.vocab.add(f"t{i}")
        log(f"[ti] vocab ({TI_HEAD + n_phases * TI_SLICE} terms) in "
            f"{time.perf_counter() - t0:.1f}s")
        add = engine.index.add_document_arrays
        phase_dps, commit_s, tiered_s_all, skip_rates = [], [], [], []
        skipped_cum = consults_cum = 0
        tiered_qps = bypass_qps = 0.0
        for phase in range(n_phases):
            head, slc = _tier_phase_corpus(rng, phase, phase_docs)
            off_h, ids_h, tfs_h, len_h = head
            off_s, ids_s, tfs_s, len_s = slc
            t0 = time.perf_counter()
            for i in range(phase_docs):
                hlo, hhi = off_h[i], off_h[i + 1]
                slo, shi = off_s[i], off_s[i + 1]
                add(f"p{phase}_d{i}",
                    np.concatenate([ids_h[hlo:hhi], ids_s[slo:shi]]),
                    np.concatenate([tfs_h[hlo:hhi], tfs_s[slo:shi]]),
                    float(len_h[i] + len_s[i]))
            ingest_s = time.perf_counter() - t0
            phase_dps.append(phase_docs / ingest_s)
            t0 = time.perf_counter()
            engine.commit()
            commit_s.append(time.perf_counter() - t0)
            # the measured chunks through the tiered dispatch, then the
            # bypass oracle for the exact-parity gate
            qs = _tier_queries(rng, phase)
            st0 = engine.tier_stats()
            with _measured_window(f"tier-{phase}", steady_state=True):
                t0 = time.perf_counter()
                tiered_hits = engine.search_batch(qs, k=TI_K)
                tiered_s = time.perf_counter() - t0
            tiered_s_all.append(tiered_s)
            st1 = engine.tier_stats()
            d_skip = st1["segments_skipped"] - st0["segments_skipped"]
            d_cons = (d_skip
                      + st1["hot_hits"] - st0["hot_hits"]
                      + st1["cold_faults"] - st0["cold_faults"])
            skipped_cum += d_skip
            consults_cum += d_cons
            skip_rates.append(d_skip / d_cons if d_cons else 0.0)
            # one pure-slice chunk + the mixed (threshold-cut) chunk
            par_idx = (list(range(TI_QBATCH))
                       + list(range(TI_QUERIES - TI_QBATCH, TI_QUERIES)))
            engine.searcher.tier_bypass = True
            try:
                par_qs = [qs[i] for i in par_idx]
                bypass_hits = engine.search_batch(par_qs, k=TI_K)
                got = [[(h.name, h.score) for h in tiered_hits[i]]
                       for i in par_idx]
                want = [[(h.name, h.score) for h in hs]
                        for hs in bypass_hits]
                if got != want:
                    _gate_failed(f"tiered top-k diverged from the "
                                 f"untiered oracle at phase {phase}")
                if phase == n_phases - 1:
                    # the oracle's timing run scores EVERYTHING (the cost
                    # an untiered engine pays by construction)
                    t0 = time.perf_counter()
                    engine.search_batch(qs, k=TI_K)
                    bypass_qps = TI_QUERIES / (time.perf_counter() - t0)
                    tiered_qps = TI_QUERIES / tiered_s
            finally:
                engine.searcher.tier_bypass = False
            engine.tier.rebalance()   # re-evict what the oracle pulled in
            if phase % 5 == 0 or phase == n_phases - 1:
                log(f"[ti] phase {phase}: {phase_dps[-1]:.0f} dps, "
                    f"commit {commit_s[-1]:.1f}s, skip "
                    f"{skip_rates[-1]:.2f}, search {tiered_s * 1e3:.0f}ms")
        st = engine.tier_stats()
        device_total = sum(int(s.device_bytes)
                           for s in engine.index._segments)
        skip_rate = skipped_cum / max(consults_cum, 1)
        # the gates: no artifact unless the run proved what it claims
        if device_total <= st["budget_bytes"]:
            _gate_failed("corpus fits the hot budget: nothing was proven "
                         "about tiering")
        if skip_rate <= 0.5:
            _gate_failed(f"cold-segment skip rate {skip_rate:.3f} <= 0.5")
        if engine.index.df_full_recomputes != 1:
            _gate_failed(f"df_full_recomputes = "
                         f"{engine.index.df_full_recomputes} (tiered "
                         f"steady-state commits must stay incremental)")
        if phase_dps[-1] < 0.5 * phase_dps[0]:
            _gate_failed(f"ingest dps decayed {phase_dps[0]:.0f} -> "
                         f"{phase_dps[-1]:.0f}")
        card_bytes = None
        if dev.type == "cuda":
            import torch
            card_bytes = int(torch.cuda.get_device_properties(
                dev).total_memory)
        log(f"[ti] {n_phases * phase_docs} docs, "
            f"{len(engine.index._segments)} segments, "
            f"{device_total >> 20}MB corpus vs "
            f"{st['budget_bytes'] >> 20}MB budget; skip {skip_rate:.3f}, "
            f"hit {st['hit_rate']:.3f}, ring stall {st['ring_stall_s']:.2f}s; "
            f"tiered {tiered_qps:.1f} q/s vs score-everything "
            f"{bypass_qps:.1f} q/s")
        return {
            "docs": n_phases * phase_docs, "phases": n_phases,
            "vocab": TI_HEAD + n_phases * TI_SLICE, "top_k": TI_K,
            "budget_mb": budget_mb,
            "segments": len(engine.index._segments),
            "corpus_device_mb": device_total >> 20,
            "device_over_budget_x": round(
                device_total / max(st["budget_bytes"], 1), 2),
            "tiered_qps": round(tiered_qps, 1),
            "bypass_qps": round(bypass_qps, 1),
            "skip_rate": round(skip_rate, 4),
            "skip_rate_per_phase": [round(r, 3) for r in skip_rates],
            "hot_hit_rate": round(st["hit_rate"], 4),
            "ring_stall_s": round(st["ring_stall_s"], 3),
            "spills": st["spills"], "evictions": st["evictions"],
            "quarantines": st["quarantines"],
            "ingest_dps_per_phase": [round(d, 1) for d in phase_dps],
            "ingest_dps_first": round(phase_dps[0], 1),
            "ingest_dps_last": round(phase_dps[-1], 1),
            "commit_s_per_phase": [round(s, 2) for s in commit_s],
            "df_full_recomputes": engine.index.df_full_recomputes,
            "parity_checked_phases": n_phases,
            "backend": _device_name(dev),
            # the budget makes the corpus cold, not the card's memory
            "card_memory_bytes": card_bytes,
            "corpus_device_bytes": device_total,
        }
    finally:
        if engine.tier is not None:
            engine.tier.close()
        shutil.rmtree(work, ignore_errors=True)


def tier_main(*, device=None, **sizes) -> None:
    """``--tier`` (artifact ``BENCH_r12.json``): the headline is the
    tiered batched q/s on the beyond-budget corpus; ``vs_baseline``
    tiered over the score-everything bypass oracle on the same engine and
    final query batch. ``TIER_DOCS``, ``TIER_PHASE`` and
    ``TIER_BUDGET_MB`` override the sizes."""
    rng = np.random.default_rng(SEED)
    ti = bench_tier(rng, device=device, **sizes)
    result = {
        "metric": "tiered_blockmax_qps_30m_docs_beyond_hbm",
        "value": ti["tiered_qps"],
        "unit": "queries/sec",
        "vs_baseline": round(ti["tiered_qps"]
                             / max(ti["bypass_qps"], 1e-9), 3),
        "extra": ti,
        "device": card_info(),
    }
    headline = {
        "tiered_qps": ti["tiered_qps"],
        "bypass_qps": ti["bypass_qps"],
        "skip_rate": ti["skip_rate"],
        "hot_hit_rate": ti["hot_hit_rate"],
        "ring_stall_s": ti["ring_stall_s"],
        "device_over_budget_x": ti["device_over_budget_x"],
        "ingest_dps_first": ti["ingest_dps_first"],
        "ingest_dps_last": ti["ingest_dps_last"],
        "docs": ti["docs"],
        "segments": ti["segments"],
        "backend": ti["backend"],
    }
    _emit_validated(result, headline, name="BENCH_r12.json")


# --------------------------------------------------------------------------
# degraded-mode serving: the host fallback against the healthy device path
# --------------------------------------------------------------------------

CP_DOCS = int(os.environ.get("COMPUTE_DOCS", 50_000))
CP_VOCAB = 30_000
CP_AVG_LEN = 60
CP_QUERIES = 256
CP_QBATCH = 32
CP_K = 10
CP_REPS = 3


def bench_compute(rng, *, n_docs: int = CP_DOCS, vocab: int = CP_VOCAB,
                  avg_len: int = CP_AVG_LEN, n_queries: int = CP_QUERIES,
                  reps: int = CP_REPS, device=None) -> dict:
    """The same measured search loop on the healthy device path and on
    the host fallback (the device forced sick), on one engine, corpus and
    query stream: q/s and p50/p99 side by side. The fallback must be bit
    for bit the device path (gated in the run before any timing) and
    must be what the degraded leg served. ``use_pallas=False`` as in the
    reference: the fallback is pinned to the plain scoring program; the
    probe interval is effectively infinite so no device probe lands in a
    timed window."""
    import shutil
    import tempfile

    from tfidf_tpu_torch.engine.compute_health import HostFallbackScorer
    from tfidf_tpu_torch.utils.device_nemesis import \
        global_device_nemesis as nem

    dev = _device(device)
    work = tempfile.mkdtemp(prefix="bench_compute_")
    engine = _engine(dev, index_path=os.path.join(work, "index"),
                     query_batch=CP_QBATCH, embedding_enabled=False,
                     use_pallas=False, compute_sick_after=2,
                     compute_probe_interval_s=1e9)
    cfg = engine.config
    try:
        t0 = time.perf_counter()
        for i in range(vocab):
            engine.vocab.add(f"t{i}")
        offsets, ids, tfs, lengths = make_doc_arrays(
            rng, n_docs, vocab, avg_len)
        add = engine.index.add_document_arrays
        for i in range(n_docs):
            lo, hi = offsets[i], offsets[i + 1]
            add(f"d{i}", ids[lo:hi], tfs[lo:hi], float(lengths[i]))
        engine.commit()
        log(f"[cp] ingest+commit {n_docs} docs in "
            f"{time.perf_counter() - t0:.1f}s")
        queries = make_queries(rng, vocab, n_queries)
        batches = [queries[i:i + CP_QBATCH]
                   for i in range(0, n_queries, CP_QBATCH)]

        # the in-run bit-parity gate, before any timing is trusted
        fb = HostFallbackScorer(engine.searcher)
        d_vals, d_ids, _k, d_names = engine.searcher.search_arrays(
            batches[0], k=CP_K)
        h_vals, h_ids, _k2, h_names = fb.search_arrays(batches[0], k=CP_K)
        if (_host(d_vals).tobytes() != h_vals.tobytes()
                or not np.array_equal(_host(d_ids), h_ids)
                or list(d_names) != list(h_names)):
            print("BENCH SELF-VALIDATION FAILED: host fallback is not "
                  "bit-identical to the device path: the degraded "
                  "numbers would measure a DIFFERENT function",
                  file=sys.stderr)
            sys.exit(1)
        log("[cp] parity gate: host fallback bit-identical to the "
            "device path")

        def timed_pass(tag: str) -> tuple[float, list]:
            lats = []
            with _measured_window(tag, steady_state=True):
                t0 = time.perf_counter()
                for _ in range(reps):
                    for b in batches:
                        b0 = time.perf_counter()
                        engine.search_batch(b, k=CP_K)
                        lats.append(time.perf_counter() - b0)
                total = time.perf_counter() - t0
            return reps * n_queries / total, lats

        def p(lats, q):
            return round(float(np.percentile(
                np.asarray(lats) * 1e3, q)), 3)

        # the healthy leg (device path), warm-up excluded
        for b in batches[:2]:
            engine.search_batch(b, k=CP_K)
        if engine.pop_fallback_served():
            print("BENCH SELF-VALIDATION FAILED: the healthy leg served "
                  "from the host fallback", file=sys.stderr)
            sys.exit(1)
        healthy_qps, h_lats = timed_pass("compute.healthy")

        # the degraded leg: the health machine driven sick, every request
        # then rides the host mirror, as a worker serves after its device
        # dies. The reference calls note_fault; the port's engine skips
        # the device only for faults the device nemesis injected, so
        # ``compute_sick_after`` injected transients make it sick (each
        # one served by the mirror), and the rule is spent after them.
        nem.add_rule("score_ell", "transient",
                     count=cfg.compute_sick_after)
        try:
            for i in range(cfg.compute_sick_after):
                engine.search_batch(batches[i % len(batches)], k=CP_K)
        finally:
            nem.clear()
        if engine.compute.state != "sick":
            print(f"BENCH SELF-VALIDATION FAILED: the compute plane is "
                  f"{engine.compute.state!r} after "
                  f"{cfg.compute_sick_after} injected faults, not sick",
                  file=sys.stderr)
            sys.exit(1)
        engine.pop_fallback_served()
        for b in batches[:2]:          # mirror build + cache warm
            engine.search_batch(b, k=CP_K)
        if not engine.pop_fallback_served():
            print("BENCH SELF-VALIDATION FAILED: degraded leg is NOT "
                  "serving from the host fallback", file=sys.stderr)
            sys.exit(1)
        degraded_qps, d_lats = timed_pass("compute.degraded")
        if not engine.pop_fallback_served():
            print("BENCH SELF-VALIDATION FAILED: fallback flag vanished "
                  "mid-measurement (a device probe leaked into the timed "
                  "window)", file=sys.stderr)
            sys.exit(1)

        return {
            "docs": n_docs, "vocab": vocab,
            "queries": n_queries, "query_batch": CP_QBATCH,
            "k": CP_K, "reps": reps,
            "healthy_qps": round(healthy_qps, 1),
            "healthy_p50_ms": p(h_lats, 50),
            "healthy_p99_ms": p(h_lats, 99),
            "degraded_qps": round(degraded_qps, 1),
            "degraded_p50_ms": p(d_lats, 50),
            "degraded_p99_ms": p(d_lats, 99),
            "degraded_slowdown_x": round(
                healthy_qps / max(degraded_qps, 1e-9), 2),
            "parity": "bit-exact",
            "backend": _device_name(dev),
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)


def compute_main(*, device=None, **sizes) -> None:
    """``--compute`` (artifact ``BENCH_r13.json``): the headline is the
    host-fallback (degraded) q/s; ``vs_baseline`` degraded over healthy,
    the share of throughput a sick-device worker keeps while it serves
    ``X-Compute-Degraded`` replies. ``COMPUTE_DOCS`` overrides the
    corpus."""
    rng = np.random.default_rng(SEED)
    cp = bench_compute(rng, device=device, **sizes)
    result = {
        "metric": "host_fallback_degraded_qps_50k_docs",
        "value": cp["degraded_qps"],
        "unit": "queries/sec",
        "vs_baseline": round(cp["degraded_qps"]
                             / max(cp["healthy_qps"], 1e-9), 3),
        "extra": cp,
        "device": card_info(),
    }
    headline = {
        "healthy_qps": cp["healthy_qps"],
        "degraded_qps": cp["degraded_qps"],
        "degraded_slowdown_x": cp["degraded_slowdown_x"],
        "healthy_p99_ms": cp["healthy_p99_ms"],
        "degraded_p99_ms": cp["degraded_p99_ms"],
        "parity": cp["parity"],
        "backend": cp["backend"],
    }
    _emit_validated(result, headline, name="BENCH_r13.json")


MAINS = {"overload": overload_main, "replay": replay_main,
         "routers": routers_main, "kernel": kernel_main,
         "hybrid": hybrid_main, "tier": tier_main,
         "compute": compute_main}
