"""One rank of ``tests/test_torch_dryrun.py``'s ``batch_axes`` case:
``python _torch_batch_axes_worker.py RANK WORLD PORT OUT``.

Four ranks over gloo form the debug mesh (2 x 2, ``data`` x ``model``).
The smoke config's parameters and optimizer state are replicated, the
batch split by rows over ``data``; one ``make_train_step(grad_accum=2,
batch_axes="data")`` step runs on the DTensors. Rank 0 also runs the
plain step on the same tensors and writes both steps' metrics to OUT."""
import json
import sys

import numpy as np
import torch
import torch.distributed as dist


def main(rank: int, world: int, port: int, out: str) -> None:
    from torch.distributed.tensor import (DTensor, Replicate,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models import init_params
    from repro_torch.models import sharding as shd
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    from repro_torch.tree import tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = M.make_debug_mesh()
        dmesh = M.device_mesh(mesh)
        cfg = configs.get_smoke("olmo-1b")
        params = init_params(cfg, 0, device="cpu")
        opt = init_opt_state(params)
        batch = {k: torch.from_numpy(v) for k, v in synthetic_lm_batch(
            np.random.default_rng(0), cfg.vocab_size, 4, 16, cfg).items()}
        opt_cfg = AdamWConfig(learning_rate=1e-3, warmup_steps=0)
        rep = [Replicate()] * dmesh.ndim

        def replicate(t):
            return distribute_tensor(t, dmesh, rep)
        specs = shd.batch_shardings(batch, mesh)
        dbatch = tree_map(lambda t, s: distribute_tensor(
            t, dmesh, shd.to_placements(s, dmesh)), batch, specs)
        step = make_train_step(cfg, opt_cfg, grad_accum=2,
                               batch_axes=shd.batch_axes(mesh))
        with implicit_replication():
            _, _, m = step(tree_map(replicate, params),
                           tree_map(replicate, opt), dbatch)
            got = {k: float(v.full_tensor() if isinstance(v, DTensor) else v)
                   for k, v in m.items()}
        if rank == 0:
            plain = make_train_step(cfg, opt_cfg, grad_accum=2)
            _, _, m = plain(params, opt, batch)
            with open(out, "w") as f:
                json.dump({"dtensor": got,
                           "plain": {k: float(v) for k, v in m.items()},
                           "placements": [str(p) for p in
                                          dbatch["tokens"].placements]}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
