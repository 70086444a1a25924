"""Small copies of the benchmark's cells that a CPU test run can hold,
and one run of such a cell."""
import io
import json
import sys
from contextlib import redirect_stdout

import _bench_path  # noqa: F401
import torch

from bench import run
from bench.harness.manifest import Cell

RAR = "rar.store21m.mb256"
LM = "olmoe.answer.azcode"


def rar_cell() -> Cell:
    return Cell(RAR, config={
        "memory": {"capacity": 4096, "embed_dim": 384, "guide_len": 8},
        "filler": {"rows": 2048, "commit_rows": 1024},
        "suite": {"n_domains": 3, "skills_per_domain": 48,
                  "shared_skills": 5, "max_operand": 8, "seq_len": 16}},
        traffic={"microbatch": 16, "warmup_steps": 2})


def lm_cell() -> Cell:
    model = dict(name="olmoe-small", family="moe", num_layers=2, d_model=128,
                 num_heads=4, num_kv_heads=4, head_dim=32, d_ff=64,
                 vocab_size=512, num_experts=8, experts_per_token=2,
                 moe_capacity_factor=4.0, moe_dispatch="scatter",
                 rope_theta=10000.0, norm_type="rmsnorm",
                 tie_embeddings=False, gated_mlp=True, remat=False,
                 param_dtype="float32")
    return Cell(LM, config={"model": model, "check": {"sample_prompts": 8}},
                traffic={"tokens_per_call": 256, "length": {
                    "median": 48, "sigma": 0.8, "min": 32, "max": 128,
                    "step": 32, "cycle": 4}})


def run_cell(cell: Cell, seed: int, steps: int, trace: int = 0,
             device="cpu") -> dict:
    """One run of ``cell`` on ``device``, its result line parsed."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell.name, "--seed", str(seed),
                       "--seconds", "60", "--trace", str(trace)],
                      device=torch.device(device), cell=cell, max_steps=steps,
                      preloaded=frozenset(sys.modules))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
