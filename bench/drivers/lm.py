"""Closed-loop calls of one LM through the measured serving engine
(``ServingEngine.generate``), judged against the plain float32 forward.

Set-up: the kernels (built once per checkout), the weights from the seed
on the device (:mod:`bench.harness.weights`), a call of each shape the
traffic sends. Window: the traffic's arrival loop; a request runs from
the hand-over of its call's prompts until the call's tokens are on the
host. The engine's prefill is
wrapped to keep each call's last-position logits (no extra device work).
After the window: a sample of the served prompts, drawn from the seed, is
run through the reference in blocks and compared by ``served_err``: over
the sampled prompts, the largest of each prompt's logit error (the served
last-position logits' largest gap to the reference's) and half its token
gap (how far the served token's reference logit lies below the
reference's best), both over the row's largest magnitude. A token served
as the argmax of logits within ``e`` of the reference lies at most ``2e``
below the reference's best, so a sound token never raises the number
above its row's logit error, and an altered one does.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from bench.harness import flops as hflops
from bench.harness import traffic as htraffic
from bench.harness import weights as hweights
from bench.harness.checks import held
from bench.harness.record import Context, Record
from bench.reference import numerics, plain_lm


def model_config(model: dict):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in model.items()})


def compare(model: dict, params: dict, tokens: list, got: list | None,
            served: list | None, cast=numerics.f32, block: int = 4) -> dict:
    """Hold logits ``got`` (V,) and ``served`` tokens of the prompts
    ``tokens`` (each (S,), lengths may differ) to the reference forward,
    rows of one length in blocks; with ``got`` None and a lower-precision
    ``cast`` the same numbers of that forward (its own best tokens served)
    come out, the control's. ``served_err`` is the number compared;
    ``logit_err`` and ``token_gap``, its two parts' largest, are readings."""
    import torch
    dev = params["embed"].device
    logit_err = token_gap = served_err = 0.0
    by_len: dict[int, list[int]] = {}
    for i, t in enumerate(tokens):
        by_len.setdefault(len(t), []).append(i)
    blocks = [idx[j:j + block] for idx in by_len.values()
              for j in range(0, len(idx), block)]
    with numerics.exact_f32(), torch.no_grad():
        for rows in blocks:
            toks = torch.as_tensor(np.stack([tokens[i] for i in rows]),
                                   device=dev)
            ref = plain_lm.lm_last_logits(model, params, toks)
            if got is None:
                mine = plain_lm.lm_last_logits(model, params, toks, cast=cast)
                srv = torch.argmax(mine, dim=1)
            else:
                mine = torch.as_tensor(np.stack([got[i] for i in rows]),
                                       device=dev)
                srv = torch.as_tensor([served[i] for i in rows], device=dev)
            scale = ref.abs().amax(dim=1).clamp(min=1e-30)
            err = (mine.float() - ref).abs().amax(dim=1) / scale
            gap = (ref.amax(dim=1)
                   - ref.gather(1, srv.long()[:, None])[:, 0]) / scale
            logit_err = max(logit_err, float(err.max()))
            token_gap = max(token_gap, float(gap.max()))
            served_err = max(served_err,
                             float(torch.maximum(err, gap / 2).max()))
    return {"served_err": served_err, "logit_err": logit_err,
            "token_gap": token_gap}


def sample(lengths: list[int], n: int, seed: int) -> list[int]:
    """``n`` of the prompts (by their ``lengths``), drawn from the seed,
    one of the longest among them."""
    rng = np.random.default_rng([seed, 1])
    longest = np.flatnonzero(np.asarray(lengths) == max(lengths))
    first = int(rng.choice(longest))
    rest = np.delete(np.arange(len(lengths)), first)
    more = rng.choice(rest, min(n, len(lengths)) - 1, replace=False)
    return sorted([first] + [int(i) for i in more])


def run(ctx: Context) -> Record:
    import torch
    from repro_torch.serving import engine as eng
    rec = Record()
    dev = ctx.device
    model = ctx.config["model"]
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.lib()
    params = hweights.lm_params(model, ctx.seed, dev)
    engine = eng.ServingEngine(model_config(model), params)
    stream = htraffic.make(ctx.traffic, ctx.config, ctx.seed)

    kept: list = []
    orig = eng.prefill

    def prefill(*a, **kw):
        out = orig(*a, **kw)
        kept.append(out[0])
        return out

    calls, outs = [], []

    def serve(tokens) -> int:
        with rec.spans.span("engine.generate"):
            out = engine.generate({"tokens": tokens},
                                  stream.max_new).cpu().numpy()
        calls.append(tokens)
        outs.append(out)
        return len(tokens)

    eng.prefill = prefill
    try:
        for tokens in stream.warmup_items():
            serve(tokens)
        del kept[:], calls[:], outs[:]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        ctx.measure(rec, stream, serve)
    finally:
        eng.prefill = orig
    rec.requests = rec.attempted = sum(len(t) for t in calls)
    rec.failed = sum(len(t) for t, o in zip(calls, outs)
                     if o.shape != (len(t), stream.max_new))
    rec.tokens = sum(t.size + len(t) * stream.max_new for t in calls)
    for t in calls:
        B, S = t.shape
        rec.flops += hflops.prefill_flops(model, B, S, B)
        for j in range(1, stream.max_new):
            rec.flops += hflops.decode_flops(model, B, S + j)
    rec.peak_dtype = model["param_dtype"]
    rec.counters["calls"] = rec.steps
    if dev.type == "cuda":
        rec.memory_peak = torch.cuda.max_memory_allocated(dev)

    # the sample, drawn from the seed, of the prompts served in the window,
    # one of the longest among them
    rows = [(c, r) for c, t in enumerate(calls) for r in range(len(t))]
    rows = [rows[i] for i in sample([calls[c].shape[1] for c, _ in rows],
                                    ctx.config["check"]["sample_prompts"],
                                    ctx.seed)]
    got = [kept[c][r].float().cpu().numpy() for c, r in rows]
    served = [int(outs[c][r, 0]) for c, r in rows]
    tokens = [calls[c][r] for c, r in rows]
    del engine, kept, outs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = compare(model, params, tokens, got, served)
    rec.counters["reference_s"] = time.perf_counter() - t_ref
    rec.checks = held(ctx.cell.name, numbers)
    return rec
