"""Training driver; port of ``repro.launch.train``.

Trains a model on the synthetic corpus of :mod:`repro_torch.data` with
AdamW, as the reference does: on a host mesh (``make_host_mesh``: the
process group's ranks, one device each, the CUDA device unless
``--device cpu``), through the sharded step of
:func:`.steps.make_sharded_train_step`, keeping the params and optimizer
state between steps as the plain global tensors that each rank computes
(``place=False``).  ``run`` sets up a process group of one rank where
none is up, and destroys it on the way out; one that it found stays.
``--arch 100m`` (the default) is the ~100M-param example model::

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch 100m --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --reduced --steps 200 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import time

import torch

from .._device import resolve_device
from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..data import DataConfig, batch_iterator
from ..models import init_params
from ..models.config import InputShape, ModelConfig
from ..optim import get_optimizer
from .mesh import make_host_mesh
from .steps import make_sharded_train_step


def train_100m_config(vocab: int = 8192) -> ModelConfig:
    """~100M params: 12L, d=768 — the end-to-end example model."""
    return ModelConfig(
        name="repro-100m", arch_type="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=vocab, head_dim=64,
        dtype="float32",
    )


def run(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
        lr: float = 3e-4, log_every: int = 10, ckpt_dir: str | None = None,
        seed: int = 0, remat: bool = False, device=None) -> list[dict]:
    """Train ``steps`` steps from weights drawn from ``seed``; returns the
    logged ``{"step", "loss", "elapsed_s"}`` records (every ``log_every``
    steps and the last) and saves the final params (plain tensors, the
    global values) to ``ckpt_dir``."""
    import torch.distributed as dist
    dev = resolve_device(device)
    own = not dist.is_initialized()
    mesh = make_host_mesh(dev)
    try:
        shape = InputShape("train", seq_len, global_batch, "train")
        optimizer = get_optimizer("adamw", lr=lr)
        step_fn, _ = make_sharded_train_step(cfg, mesh, shape, optimizer,
                                             remat=remat)
        params = init_params(cfg, seed, dev)
        opt_state = optimizer.init(params)
        data = batch_iterator(
            DataConfig(cfg.vocab_size, seq_len, global_batch, seed=seed),
            steps, corpus_tokens=global_batch * (seq_len + 1) * 64)

        history = []
        t0 = time.perf_counter()
        for i, np_batch in enumerate(data):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in np_batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 place=False)
            if i % log_every == 0 or i == steps - 1:
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                rec = {"step": i, "loss": loss, "elapsed_s": round(dt, 1)}
                history.append(rec)
                print(f"step {i:5d}  loss {loss:.4f}  ({dt:.1f}s)",
                      flush=True)
        if ckpt_dir:
            save_checkpoint(ckpt_dir, steps, params)
    finally:
        if own:
            dist.destroy_process_group()
    return history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="100m",
                    help="'100m' or an assigned arch id")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.arch == "100m":
        cfg = train_100m_config()
    else:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    hist = run(cfg, steps=args.steps, global_batch=args.batch,
               seq_len=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
               device=args.device)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
