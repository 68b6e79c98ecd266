"""Training entry point: ``python -m repro_torch.launch.train --arch <id>``.

Builds the arch's model (reduced or full) on ``--device`` (default
``cuda``, which fails without CUDA; ``--device cpu`` runs the kernels'
plain versions) from a ``torch.Generator`` seeded by ``--seed``, the data
stream and the train step, and runs the fault-tolerant loop with
checkpointing.  The archs are the dense LMs (``qwen2-1.5b``,
``qwen3-8b``, ``minitron-8b``), the MoE LMs (``deepseek-v2-236b``, MLA
and MoE; ``dbrx-132b``), ``dlrm-rm2`` and the GNNs (``gcn-cora``,
``pna``, ``meshgraphnet``, ``dimenet``):

    python -m repro_torch.launch.train --arch dlrm-rm2 --device cpu --steps 5
    python -m repro_torch.launch.train --arch dlrm-rm2 --preset full --batch 65536
    python -m repro_torch.launch.train --arch qwen3-8b --device cpu --steps 3
    python -m repro_torch.launch.train --arch deepseek-v2-236b --device cpu \
        --steps 3
    python -m repro_torch.launch.train --arch qwen2-1.5b --preset full \
        --batch 4 --seq 4096 --microbatches 2
    python -m repro_torch.launch.train --arch pna --device cpu --steps 3

An LM under ``--preset full`` needs ``--batch`` and ``--seq``.  The GNNs
train on the sampled node-classification stream, which MeshGraphNet and
DimeNet cannot read (they need a mesh's or molecules' fields): both exit
with a message under either preset.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.configs.common import GraphDims
from repro_torch.core.exec import resolve_device
from repro_torch.train.data import (RecsysStream, SampledGraphStream,
                                    TokenStream)
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.trainstep import make_train_step, named_params
from repro_torch.utils import get_logger

log = get_logger("launch.train")


def _stream_for(arch, cfg, example, args):
    if arch.family == "lm":
        b, s = (None, None) if example is None else example["tokens"].shape
        return TokenStream(vocab=cfg.vocab, batch=args.batch or b,
                           seq=args.seq or s, seed=args.seed)
    if arch.family == "recsys":
        return RecsysStream(n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                            hotness=cfg.hotness,
                            vocab_sizes=cfg.vocab_sizes,
                            batch=args.batch or 64, seed=args.seed)
    # gnn: sampled stream over a synthetic graph
    return SampledGraphStream(n_nodes=5000, avg_degree=8,
                              d_feat=getattr(cfg, arch.layout.width),
                              n_classes=cfg.n_classes,
                              batch_nodes=args.batch or 64, fanout=[5, 3],
                              seed=args.seed)


def model_for(arch, cfg, device, generator):
    """The arch's module on ``device``, its weights drawn from
    ``generator``."""
    return arch.model(cfg, device=device, generator=generator)


def _not_sampled(arch) -> list[str]:
    """The fields of a GNN's batch layout that the sampled
    node-classification stream does not give."""
    fields = arch.layout.fields(arch.config, GraphDims(1, 1))
    return [k for k in fields if k not in SampledGraphStream.FIELDS]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(ASSIGNED))
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length of an LM's batches")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="runs/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="torch device of the model and the step (cuda "
                         "fails without CUDA; cpu runs the plain kernels)")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> Trainer:
    """The model, stream, step and loop of ``args``, not yet run."""
    import torch

    arch = get_arch(args.arch)
    if (arch.family == "lm" and args.preset == "full"
            and (args.batch is None or args.seq is None)):
        raise SystemExit(f"--preset full for the LM {args.arch} needs "
                         f"--batch and --seq (e.g. --batch 4 --seq 4096)")
    missing = _not_sampled(arch) if arch.family == "gnn" else []
    if missing:
        if args.preset == "smoke":
            raise SystemExit(
                f"{args.arch} smoke training uses the molecule layout; "
                "run examples/gnn_training.py instead")
        raise SystemExit(
            f"--preset full for {args.arch}: the sampled graph stream gives "
            f"{', '.join(SampledGraphStream.FIELDS)}, not "
            f"{', '.join(missing)}, so {args.arch} cannot train on it")
    device = resolve_device(args.device)
    cfg, example = (arch.smoke() if args.preset == "smoke"
                    else (arch.config, None))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = model_for(arch, cfg, device, gen)
    n_params = sum(p.numel() for p in model.parameters())
    log.info("arch=%s params=%.3fM device=%s", args.arch, n_params / 1e6,
             device)

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps,
                        grad_compress=args.grad_compress)
    opt_state = adamw_init(named_params(model), opt_cfg)
    stream = _stream_for(arch, cfg, example, args)
    step = make_train_step(arch.loss_fn, model, opt_cfg,
                           microbatches=args.microbatches)
    return Trainer(step, stream,
                   LoopConfig(total_steps=args.steps,
                              ckpt_every=args.ckpt_every,
                              ckpt_dir=f"{args.ckpt_dir}/{args.arch}"),
                   model, opt_state)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    trainer = build(args)
    end = trainer.fit()
    last = trainer.metrics_log[-1] if trainer.metrics_log else {}
    log.info("done at step %d: %s", end, last)
    print(f"final step={end} loss={last.get('loss')}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
