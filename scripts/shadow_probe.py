"""Where the async shadow drainer's serving time goes on the card, and the
RAR main path's requests/s of one tree against another.

    python3 scripts/shadow_probe.py                   # the drain modes
    python3 scripts/shadow_probe.py --rate-only --root DIR   # inline only

Both serve ``chip_smoke.py``'s R1 workload (the 64-request pool, 2 passes,
microbatch 8, precomputed embeddings, random tiers from its seeds) through
``MicrobatchRAR`` on the card, the kernels built first and one warm-up run
per configuration, unjournaled and with no drain delay.

``--contention N`` serves nothing: it times N small torch ops (an add on
8 floats, a sync every 50) on one thread alone, beside a thread issuing
the same ops (on the card, on a stream of its own), and beside a thread
of pure Python, on the card and on the CPU, to separate what two
threads issuing ops cost each other from the GIL alone.

``--rate-only`` serves inline only, with the ``chip_smoke.py`` and the
package of the tree at ``--root`` (default: this one), and prints each
run's requests/s: the main path of two trees compared in one call.

Otherwise, on this tree: inline, deferred and async at flush-every 4
(Phase A2's cadence) and adaptive, ``--reps`` runs each; then async again
at each ``--switch`` interval of the interpreter (``sys.setswitchinterval``:
how long a thread that wants the GIL waits before the holder is asked to
drop it). Each run reports requests/s, strong calls, the shadow items
drained and the drains, and, per thread, the host seconds spent waiting
for the store lock, holding it, inside ``process_batch``, in the closing
barrier and in drains, and the thread's CPU seconds in the last three
(``time.thread_time``: time it ran, not time it waited). All numbers are
host-clock; the last line is one JSON object with every run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time
from pathlib import Path


def instrument(ctrl, stats):
    """Time, per thread, the store lock's waits and holds, the serve
    calls, the barriers and the drains of ``ctrl`` (the last three also in
    the thread's CPU seconds)."""
    def slot(key):
        per = stats.setdefault(threading.current_thread().name, {})
        return per, key

    def add(key, dt):
        per, key = slot(key)
        per[key] = per.get(key, 0.0) + dt
        per[key + "_n"] = per.get(key + "_n", 0) + 1

    lock, held = ctrl.commit_stream.lock, threading.local()
    acquire, release = lock.acquire, lock.release

    def timed_acquire(blocking=True, timeout=-1):
        t0 = time.perf_counter()
        got = acquire(blocking, timeout)
        t1 = time.perf_counter()
        add("lock_wait_s", t1 - t0)
        stack = getattr(held, "stack", [])
        stack.append(t1)
        held.stack = stack
        return got

    def timed_release():
        t0 = held.stack.pop()
        if not held.stack:
            add("lock_hold_s", time.perf_counter() - t0)
        release()
    lock.acquire, lock.release = timed_acquire, timed_release

    def timed(fn, key):
        def run(*a, **kw):
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return fn(*a, **kw)
            finally:
                add(key, time.perf_counter() - t0)
                add(key.replace("_s", "_cpu_s"), time.thread_time() - c0)
        return run
    ctrl.process_batch = timed(ctrl.process_batch, "process_batch_s")
    ctrl.flush_shadow = timed(ctrl.flush_shadow, "flush_s")
    ctrl.shadow.runner = timed(ctrl.shadow.runner, "drain_s")


def contention(torch, device, n_ops: int) -> list[dict]:
    """Per-op host cost of small torch ops issued by one thread alone and
    beside a second thread: the second issuing the same ops (on a stream
    of its own on the card, as the drainer), or pure Python that never
    releases the GIL but at the switch interval. A sync ends every 50
    ops. Returns one row per case with each thread's microseconds an op
    (wall) and CPU seconds."""
    def ops(dev, stream, out, n_ops=n_ops):
        def run():
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            with ctx:
                t = torch.zeros(8, device=dev)
                t0, c0 = time.perf_counter(), time.thread_time()
                for i in range(n_ops):
                    t = t + 1
                    if i % 50 == 49:
                        t.sum().item()
                out.update(us_per_op=(time.perf_counter() - t0) / n_ops * 1e6,
                           cpu_s=time.thread_time() - c0)
        return run

    def python(stop, out):
        def run():
            c0, x = time.thread_time(), 0
            while not stop.is_set():
                for i in range(1000):
                    x += i
            out.update(cpu_s=time.thread_time() - c0)
        return run

    rows = []
    cases = [("cpu ops alone", "cpu", None),
             ("cpu ops + cpu ops", "cpu", "ops"),
             ("cpu ops + python", "cpu", "python")]
    if device.type == "cuda":
        cases = [("cuda ops alone", device, None),
                 ("cuda ops + cuda ops", device, "ops"),
                 ("cuda ops + python", device, "python")] + cases
    for tag, dev, other in cases:
        a, b, stop = {}, {}, threading.Event()
        ops(dev, None, {})()                                   # warm
        side = (torch.cuda.Stream(dev) if other == "ops" and
                torch.device(dev).type == "cuda" else None)
        # beside pure Python an op waits up to a switch interval for the
        # GIL, so that case times fewer ops
        n = n_ops if other != "python" else max(50, n_ops // 100)
        threads = [threading.Thread(target=ops(dev, None, a, n))]
        if other == "ops":
            threads.append(threading.Thread(target=ops(dev, side, b)))
        elif other == "python":
            threads.append(threading.Thread(target=python(stop, b)))
        for t in threads:
            t.start()
        threads[0].join()
        stop.set()
        for t in threads[1:]:
            t.join()
        rows.append(dict(case=tag, first=a, second=b or None))
        print(f"contention {tag}: first thread {a['us_per_op']:.3f} us/op, "
              f"CPU {a['cpu_s']:.3f} s"
              + (f"; second thread {b.get('us_per_op', 0.0):.3f} us/op, CPU "
                 f"{b['cpu_s']:.3f} s" if b else ""), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="tree whose chip_smoke.py and package serve")
    ap.add_argument("--rate-only", action="store_true",
                    help="inline requests/s only")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--contention", type=int, default=0, metavar="N_OPS",
                    help="time N_OPS small torch ops a thread, alone and "
                         "beside a second thread, instead of serving")
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script without a card")
    ap.add_argument("--switch", type=float, nargs="*",
                    default=[0.005, 0.001, 0.0002],
                    help="interpreter switch intervals for async (s)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import chip_smoke as cs
    import torch
    cuda = torch.device(args.device)
    if cuda.type == "cuda" and not torch.cuda.is_available():
        print("shadow_probe: no CUDA card visible", file=sys.stderr)
        return 2
    from repro_torch.configs import rar_system
    from repro_torch.kernels import _build
    from repro_torch.models import init_params

    if cuda.type == "cuda":
        _build.lib()
        card = cs.card_line()
    else:
        card = "none (CPU rehearsal)"
    vocab, prompts, greqs, embs = cs.workload()
    tiers = (init_params(rar_system.WEAK, cs.SEEDS["weak"], device=cuda),
             init_params(rar_system.STRONG, cs.SEEDS["strong"], device=cuda))
    mb, n = cs.MICROBATCHES[0], cs.PASSES * cs.POOL
    import repro_torch
    print(f"card: {card}; tree {args.root} (package "
          f"{Path(repro_torch.__file__).parent})", flush=True)
    out = {"root": args.root, "runs": []}

    def serve(tag, cfg, reps):
        """``reps`` timed runs after one warm-up; ``cfg`` None serves
        inline through the tree's own ``serve_rar`` defaults (the only
        call an older tree's ``chip_smoke.py`` takes)."""
        for rep in range(reps + 1):
            stats = {}
            if cfg is None:
                c = cs.serve_rar(cuda, tiers, None, mb, prompts, greqs, embs,
                                 vocab)
            else:
                c = cs.serve_rar(cuda, tiers, None, mb, prompts, greqs, embs,
                                 vocab, cfg=cfg,
                                 setup=lambda ctrl: instrument(ctrl, stats))
                c[0].close_shadow(timeout=cs.WAIT_S)
            if rep == 0:
                continue
            strong = sum(o.strong_calls for o in c[1])
            q = getattr(c[0], "shadow", None)
            drained = (q.items_drained, q.drains) if q else (None, None)
            out["runs"].append(dict(tag=tag, rep=rep, req_per_s=n / c[2],
                                    wall_s=c[2], strong_calls=strong,
                                    items_drained=drained[0],
                                    drains=drained[1], threads=stats))
            per = "; ".join(
                f"{th}: " + ", ".join(f"{k} {v:.6f}" if isinstance(v, float)
                                      else f"{k} {v}"
                                      for k, v in sorted(d.items()))
                for th, d in sorted(stats.items()))
            print(f"{tag} rep {rep}: {n / c[2]:.3f} req/s, wall "
                  f"{c[2]:.6f} s, strong calls {strong}, items drained "
                  f"{drained[0]} in {drained[1]} drains"
                  f"{'; ' + per if per else ''}", flush=True)

    if args.contention:
        out["contention"] = contention(torch, cuda, args.contention)
    elif args.rate_only:
        serve("inline", None, args.reps)
    else:
        flush = cs.A2_FLUSH
        for mode, every in (("inline", 1), ("deferred", flush),
                            ("async", flush), ("adaptive", flush)):
            cfg = rar_system.make_rar_config(shadow_mode=mode,
                                             shadow_flush_every=every)
            serve(f"{mode}-{every}", cfg, args.reps)
        default = sys.getswitchinterval()
        try:
            for sw in args.switch:
                sys.setswitchinterval(sw)
                cfg = rar_system.make_rar_config(shadow_mode="async",
                                                 shadow_flush_every=flush)
                serve(f"async-{flush} switch {sw}", cfg, args.reps)
                cfg = rar_system.make_rar_config(shadow_mode="deferred",
                                                 shadow_flush_every=flush)
                serve(f"deferred-{flush} switch {sw}", cfg, 1)
        finally:
            sys.setswitchinterval(default)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
