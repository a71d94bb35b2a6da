"""Every parallel path of the port in one run on a (data, pipe, model) mesh
(the analogue of the JAX package's `__graft_entry__.dryrun_multichip`):

    python -m clipcap_tpu_torch.tools.dryrun_multichip --device cpu --world 8
    torchrun --nproc_per_node N -m clipcap_tpu_torch.tools.dryrun_multichip

It runs one DP + ZeRO train step, then `pp_train` (the GPT-2 stack
pipelined over `pipe`), `tp_decode` (GPT-J heads over `model`),
`dp_int8_decode` (int8 GPT-2 decode, batch over every rank), `dp_serving`
(the continuous-batching engine, slots over every rank), `sp_encode`
(ring-attention ViT over `model`) and `ep_moe` (the MoE mapper's experts
over `model`, forward and gradient), at the JAX drive's tiny configs. The
mesh is JAX's: model 2 for an even world of at least 4, pipe 2 when that
leaves an even data axis at a world of at least 8; a path whose axis is 1
is skipped, as in JAX.

`--device cpu --world N` spawns N processes joined by gloo through a
`file://` rendezvous in a temporary directory; under torchrun on GPUs the
ranks join NCCL. Global rank 0 prints JAX's `dryrun_multichip OK: ...`
line; a rank that fails makes the run exit nonzero.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def _tiny_configs():
    from ..core.config import CaptionerConfig, GPT2Config, MapperConfig, TrainConfig

    lm_cfg = GPT2Config(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=4)
    map_cfg = MapperConfig(dim_clip=32, dim_embedding=64, prefix_length=8, clip_length=4,
                           num_layers=2, num_heads=4)
    cap_cfg = CaptionerConfig(lm_type="gpt2", mapper=map_cfg)
    train_cfg = TrainConfig(optimizer_lr=1e-3, scheduler_warmup_steps=2, total_steps=100,
                            gradient_clip_val=-1.0, autoclip_history=128, remat=True)
    return cap_cfg, lm_cfg, map_cfg, train_cfg


def mesh_spec(n: int):
    """JAX's layout for n devices: (data, pipe, model) = 2x2x2 at 8."""
    from ..core.mesh import MeshSpec

    model = 2 if n % 2 == 0 and n >= 4 else 1
    pipe = 2 if n % (2 * model) == 0 and n >= 8 else 1
    return MeshSpec(data=n // (model * pipe), pipe=pipe, model=model)


def dryrun(device: str = "cpu") -> str:
    """Run every path on this rank (the default group already joined, or
    joined here); returns the OK line."""
    from ..core.mesh import (MeshSpec, init_distributed, make_mesh, mesh_shape, shard_batch)
    from ..decode.engine import GenerationSettings, generate
    from ..decode.serving import Request, ServingEngine
    from ..models import gpt2
    from ..models.captioner import Captioner
    from ..parallel.dp import dp_decode_shardings
    from ..train.train_step import create_train_state, make_train_step

    _, n = init_distributed(device)
    dev = torch.device(device if device == "cpu" else f"cuda:{torch.cuda.current_device()}")
    cap_cfg, lm_cfg, map_cfg, train_cfg = _tiny_configs()
    spec = mesh_spec(n)
    mesh = make_mesh(spec, device_type=dev.type)
    shape = mesh_shape(mesh)

    # one DP + ZeRO train step: params and AdamW moments sharded over data
    model = Captioner(cap_cfg, lm_cfg, device=dev, seed=0)
    state, tx = create_train_state(0, cap_cfg, lm_cfg, train_cfg, model=model, device=dev,
                                   mesh=mesh, zero=True)
    rng = np.random.default_rng(0)
    b = 2 * shape["data"]
    tokens = rng.integers(1, 256, size=(b, 16)).astype(np.int64)
    tokens[:, -3:] = -1
    prefix = rng.normal(size=(b, map_cfg.dim_clip)).astype(np.float32)
    batch = {k: torch.tensor(v, device=dev)
             for k, v in shard_batch(mesh, {"tokens": tokens, "prefix": prefix}).items()}
    step_fn = make_train_step(cap_cfg, lm_cfg, train_cfg, tx, mesh=mesh)
    state, metrics = step_fn(state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")

    # the GPipe train step over `pipe`, batch still over `data`
    pp_loss = None
    if shape["pipe"] > 1:
        from ..parallel.pp import make_gpt2_pp_apply

        pp_model = Captioner(cap_cfg, lm_cfg, device=dev, seed=3)
        pp_state, pp_tx = create_train_state(3, cap_cfg, lm_cfg, train_cfg, model=pp_model,
                                             device=dev)
        pp_apply = make_gpt2_pp_apply(lm_cfg, mesh, n_micro=2, remat=train_cfg.remat)
        pp_step = make_train_step(cap_cfg, lm_cfg, train_cfg, pp_tx, mesh=mesh,
                                  lm_apply=functools.partial(pp_apply, pp_model.lm))
        pp_state, pp_metrics = pp_step(pp_state, batch)
        pp_loss = float(pp_metrics["loss"])
        if not np.isfinite(pp_loss):
            raise RuntimeError(f"non-finite pp loss {pp_loss}")

    # tensor-parallel GPT-J decode through the engine on the same mesh
    tp_tokens = None
    if shape["model"] > 1:
        from ..core.config import GPTJConfig
        from ..models.gptj import GPTJ
        from ..parallel.tp import gptj_decode_shardings

        gptj_cfg = GPTJConfig(vocab_size=128, n_positions=64, n_embd=64, n_layer=2,
                              n_head=2 * shape["model"], rotary_dim=8)
        gptj = GPTJ(gptj_cfg, device=dev, seed=1)
        sh = gptj_decode_shardings(mesh, gptj)
        gptj.shard_heads(sh.model_group)
        dec_prefix = torch.tensor(rng.normal(size=(2 * shape["data"], 4, gptj_cfg.n_embd))
                                  .astype(np.float32), device=dev)
        out = generate(gptj, dec_prefix, GenerationSettings(max_new_tokens=6, greedy=True),
                       device=dev, cache_constraint=sh.constrain_cache)
        tp_tokens = out["tokens"]
        if tuple(tp_tokens.shape) != (2 * shape["data"], 6):
            raise RuntimeError(f"tp tokens {tuple(tp_tokens.shape)}")

    # data-parallel int8 GPT-2 decode: weights on every rank, the int8 KV
    # cache batch-sharded over the full world
    dp_mesh = make_mesh(MeshSpec(data=n, model=1), device_type=dev.type)
    dsh = dp_decode_shardings(dp_mesh)
    g2_cfg = type(lm_cfg)(vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4)
    g2 = gpt2.quantize_params(gpt2.GPT2(g2_cfg, device=dev, seed=2))
    dp_prefix = torch.tensor(rng.normal(size=(n, 4, g2_cfg.n_embd)).astype(np.float32),
                             device=dev).to(torch.bfloat16)
    dp_out = generate(g2, dp_prefix, GenerationSettings(max_new_tokens=6, greedy=True),
                      device=dev, cache_constraint=dsh.constrain_cache)
    if tuple(dp_out["tokens"].shape) != (n, 6):
        raise RuntimeError(f"dp tokens {tuple(dp_out['tokens'].shape)}")

    # continuous-batching serving, slots over the world, refills mid-stream
    eng = ServingEngine(g2, g2_cfg, prefix_len=4,
                        settings=GenerationSettings(max_new_tokens=6, greedy=True,
                                                    eos_token_id=1),
                        slots=n, steps_per_sync=3, cache_constraint=dsh.constrain_cache,
                        device=dev)
    reqs = [Request(i, i, max_length=3 + (i % 4)) for i in range(2 * n)]
    served = eng.serve(reqs, prefix_pool=torch.cat([dp_prefix, dp_prefix]))
    if len(served) != 2 * n:
        raise RuntimeError(f"served {len(served)} of {2 * n}")

    # ring-attention ViT: tokens over `model`, batch over `data`
    sp_ok = None
    if shape["model"] > 1:
        from ..core.config import ViTConfig
        from ..models.vit import ViT
        from ..parallel.sp import make_vit_sp_apply

        vit_cfg = ViTConfig(image_size=28, patch_size=4, width=32, layers=2, heads=4,
                            output_dim=16, style="clip")
        vit = ViT(vit_cfg, device=dev, seed=4)
        pixels = torch.tensor(rng.normal(size=(2 * shape["data"], 3, 28, 28))
                              .astype(np.float32), device=dev)
        with torch.no_grad():
            emb = make_vit_sp_apply(vit_cfg, mesh)(vit, pixels)
        sp_ok = bool(torch.isfinite(emb).all())
        if tuple(emb.shape) != (2 * shape["data"], 16) or not sp_ok:
            raise RuntimeError(f"sp encode {tuple(emb.shape)}, finite {sp_ok}")

    # the MoE mapper, experts over `model`: one forward and gradient
    ep_ok = None
    if shape["model"] > 1:
        from ..models import moe
        from ..parallel.ep import expert_constraint, shard_experts

        moe_cfg = moe.MoEConfig(n_experts=2 * shape["model"], n_top=2, capacity_factor=2.0)
        mapper = shard_experts(moe.init(map_cfg, moe_cfg, device=dev, seed=5), mesh)
        moe_prefix = torch.tensor(rng.normal(size=(4, map_cfg.dim_clip)).astype(np.float32),
                                  device=dev)
        out, aux = moe.apply(mapper, moe_prefix, expert_constraint=expert_constraint(mesh))
        moe_val = (out**2).sum() + moe_cfg.aux_loss_weight * aux
        grads = torch.autograd.grad(moe_val, list(mapper.parameters()))
        ep_ok = bool(torch.isfinite(moe_val)) and all(bool(torch.isfinite(g).all())
                                                      for g in grads)
        if not ep_ok:
            raise RuntimeError("non-finite MoE loss or gradient")

    return (f"dryrun_multichip OK: mesh=({shape}), batch={b}, loss={loss:.4f}, "
            f"step={int(state.step)}, "
            f"pp_train={'ok' if pp_loss is not None else 'skipped(pipe=1)'}, "
            f"tp_decode={'ok' if tp_tokens is not None else 'skipped(1d mesh)'}, "
            f"dp_int8_decode=ok, dp_serving=ok, "
            f"sp_encode={'ok' if sp_ok is not None else 'skipped(1d mesh)'}, "
            f"ep_moe={'ok' if ep_ok is not None else 'skipped(1d mesh)'}")


# --- spawned gloo processes on the CPU -----------------------------------------------------


def _spawned(rank: int, world: int, rendezvous: str, fn, args):
    """A spawned rank: join the gloo group, run fn(*args), leave."""
    import torch.distributed as dist

    from ..core.mesh import init_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=rendezvous)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_spawned(fn, world: int, args=(), timeout: float = 60.0, workdir=None) -> None:
    """Run fn(*args) in `world` spawned CPU processes joined by gloo (a
    `file://` rendezvous in `workdir`, no TCP port). Raises when a rank
    fails, and when the run outlives `timeout` seconds (its processes are
    terminated first): a hung collective cannot hang the caller."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        rendezvous = "file://" + str(Path(tmp) / "rendezvous")
        ctx = mp.start_processes(_spawned, args=(world, rendezvous, fn, tuple(args)),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(5)
                raise TimeoutError(f"{world} spawned ranks ran past {timeout} s")


def _print_dryrun(device: str) -> None:
    from ..core.mesh import is_writer

    line = dryrun(device)
    if is_writer():
        print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="drive every parallel path on a tiny mesh")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL, one torchrun process per card; cpu: gloo")
    ap.add_argument("--world", type=int, default=None,
                    help="with --device cpu: spawn this many processes (default 8)")
    ap.add_argument("--timeout", type=float, default=180.0,
                    help="seconds the spawned ranks may take (--device cpu)")
    args = ap.parse_args(argv)
    if args.device == "cpu" and "RANK" not in os.environ:
        run_spawned(_print_dryrun, args.world or 8, ("cpu",), timeout=args.timeout)
        return 0
    from ..core.mesh import process_group_scope

    with process_group_scope():
        _print_dryrun(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
