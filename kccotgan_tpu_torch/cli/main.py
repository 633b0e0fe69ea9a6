"""Command-line entry point of the trainer.

Counterpart of ``kccotgan_tpu/cli/main.py``: the same flags, defaults
and preset overlay (a flag typed on the command line wins over the
preset; ``provided_dests`` tells typed flags from defaults, abbreviated
and ``--flag=value`` forms included).  The layout and compile flags
exist only for the TPU ("Not to port") and are refused with an argparse
error naming why.  ``--num_devices N`` and ``--seq_devices S`` train on
a mesh of ``N x S`` ranks (``parallel/``): under torchrun the process
joins the job as its rank; otherwise ``main`` spawns the ranks on this
host, each on its device (``parallel/launch.py``), and prints rank 0's
summary.  ``--local_sinkhorn`` takes the per-shard Sinkhorn instead of
the exact global-batch one.  The summary names the mesh and the
backend.  The smoothing (``--kernel``,
``--init_sigma``, ``--decaying_sigma``) and dropout (``--dropout``,
``--rnn_dropout``) flags reach the trainer, and ``--profile_steps a,b``
traces steps a to b into ``<run_dir>/profile/``.

Usage (on the card unless ``main`` is given ``device="cpu"``):
  python -m kccotgan_tpu_torch.cli.main --preset mmnist_full --dname synthetic --kernel_impl pallas --num_devices 2 --seq_devices 2
  torchrun --nproc_per_node 4 -m kccotgan_tpu_torch.cli.main --preset mmnist_full --dname synthetic --num_devices 4
  python -m kccotgan_tpu_torch.cli.main --preset mmnist_full --dname synthetic --kernel_impl pallas --max_steps 100
  python -m kccotgan_tpu_torch.cli.main --preset mmnist_full --dname synthetic --kernel_impl pallas --kernel 3d --decaying_sigma --dropout 0.1 --rnn_dropout 0.1
  python -m kccotgan_tpu_torch.cli.main --preset mmnist_full --data_path /data --checkpoint --ckpt_path trained/<run>/ckpt
  python -m kccotgan_tpu_torch.cli.main --preset mmnist_full --dname synthetic --kernel_impl pallas --max_steps 12 --profile_steps 10,11
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from ..config import PRESETS, ModelConfig, TrainConfig, get_preset

__all__ = ["build_parser", "config_from_args", "main", "provided_dests"]


class _Refused(argparse.Action):
    """A flag of the JAX trainer that the port refuses, with its reason."""

    def __init__(self, option_strings, dest, reason: str, **kwargs):
        self.reason = reason
        super().__init__(option_strings, dest, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        raise argparse.ArgumentError(self, self.reason)


_TPU_ONLY = "a TPU-only option (ROADMAP 'Not to port'): the port runs the batch-major, unpacked layout"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="kccotgan_tpu_torch trainer")
    p.add_argument("--preset", type=str, default=None, choices=sorted(PRESETS))
    p.add_argument("-d", "--dname", type=str, default="mmnist",
                   choices=["synthetic", "mmnist", "mazes", "robot_push", "kth",
                            "penn_action", "animation", "human_action", "ucf"])
    p.add_argument("-s", "--seed", type=int, default=1)
    p.add_argument("-gfs", "--g_filter_size", type=int, default=8)
    p.add_argument("-dss", "--d_state_size", type=int, default=8)
    p.add_argument("-dfs", "--d_filter_size", type=int, default=8)
    p.add_argument("-tts", "--total_time_steps", type=int, default=15)
    p.add_argument("-its", "--int_time_steps", type=int, default=5)
    p.add_argument("-nch", "--n_channels", type=int, default=1)
    p.add_argument("-nz", "--z_channels", type=int, default=128)
    p.add_argument("-sinke", "--sinkhorn_eps", type=float, default=1.0)
    p.add_argument("-sinkl", "--sinkhorn_l", type=int, default=100)
    p.add_argument("-reg_p", "--reg_penalty", type=float, default=1.0)
    p.add_argument("-bs", "--batch_size", type=int, default=2)
    p.add_argument("-p", "--data_path", type=str, default="../data")
    p.add_argument("-save", "--save_freq", type=int, default=10)
    p.add_argument("--ckpt_freq", type=int, default=10000)
    p.add_argument("-lr", "--lr", type=float, default=5e-4)
    p.add_argument("-bn", "--batch_norm", action="store_true", default=True)
    p.add_argument("--no_batch_norm", dest="batch_norm", action="store_false")
    p.add_argument("-dp", "--dropout", type=float, default=0.0)
    p.add_argument("-rdp", "--rnn_dropout", type=float, default=0.0)
    p.add_argument("-sc", "--scaling_coef", type=float, default=15.0,
                   help="effective multiplier is 1/value")
    p.add_argument("-k", "--kernel", type=str, default="none", choices=["1d", "2d", "3d", "none"])
    p.add_argument("-xh", "--height", type=int, default=64)
    p.add_argument("-xw", "--width", type=int, default=64)
    p.add_argument("-ne", "--n_epochs", type=int, default=100)
    p.add_argument("-wu", "--warmup", type=int, default=10000)
    p.add_argument("-isig", "--init_sigma", type=float, default=5.0)
    p.add_argument("-desig", "--decaying_sigma", action="store_true")
    p.add_argument("--nan_recovery_retries", type=int, default=0,
                   help="on a non-finite loss, restore the last verified checkpoint, "
                        "re-seed the noise and continue, up to this many times "
                        "(0 = stop)")
    p.add_argument("-ckpt", "--checkpoint", action="store_true", help="resume from --ckpt_path")
    p.add_argument("-cn", "--ckpt_path", type=str, default="",
                   help="a run's checkpoint directory (<out_dir>/<run_name>/ckpt)")
    p.add_argument("--out_dir", type=str, default="trained")
    p.add_argument("--run_name", type=str, default="")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--num_devices", type=int, default=1, help="data-parallel ranks (the batch's rows)")
    p.add_argument("--seq_devices", type=int, default=1,
                   help="sequence-parallel ranks (the generator's frames, ring-relay ConvLSTMs); "
                        "total_time_steps and the predicted steps must divide by it")
    p.add_argument("--local_sinkhorn", action="store_true",
                   help="each rank's Sinkhorn on its shard, averaged, instead of the exact global batch's")
    p.add_argument("--cost_method", type=str, default="gram", choices=["gram", "exact"])
    p.add_argument("--solver", type=str, default="auto", choices=["auto", "scan", "pallas"])
    p.add_argument("--compile_cache", action=_Refused, reason="JAX's compilation cache: " + _TPU_ONLY)
    p.add_argument("--compute_dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"],
                   help="input precision of the convolutions and matmuls")
    p.add_argument("--remat_policy", action=_Refused, reason=_TPU_ONLY)
    p.add_argument("--conv_packing", action=_Refused, reason=_TPU_ONLY)
    p.add_argument("--kernel_impl", type=str, default=TrainConfig.kernel_impl,
                   choices=["scan", "pallas", "auto"],
                   help="recurrence engine: plain loops under autograd ('scan', 'auto'), "
                        "or every ConvLSTM and LSTM recurrence through its CUDA kernels ('pallas')")
    p.add_argument("--time_major", action=_Refused, nargs=0, reason=_TPU_ONLY)
    p.add_argument("--no_time_major", action=_Refused, nargs=0, reason=_TPU_ONLY)
    p.add_argument("--profile_steps", type=str, default=None,
                   help="'a,b': trace steps a to b (torch.profiler) into <run_dir>/profile/")
    # accepted for parity with the reference, validated, otherwise unused
    p.add_argument("-gss", "--g_state_size", type=int, default=8)
    p.add_argument("-epd", "--enc_period", type=str, default="1,1,1,1")
    p.add_argument("-dpd", "--dec_period", type=str, default="1,1,1,1")
    return p


# CLI dest -> ModelConfig / TrainConfig field, for the flags laid over a --preset
_MODEL_DESTS = {
    "d_state_size": "d_state_size",
    "g_filter_size": "g_filter_size", "d_filter_size": "d_filter_size",
    "n_channels": "n_channels", "z_channels": "z_channels",
    "batch_norm": "use_norm", "dropout": "dropout",
    "rnn_dropout": "rnn_dropout", "height": "x_height", "width": "x_width",
}
_TRAIN_DESTS = {
    "dname": "dname", "data_path": "data_path", "batch_size": "batch_size",
    "total_time_steps": "total_time_steps", "int_time_steps": "int_time_steps",
    "n_epochs": "n_epochs", "sinkhorn_eps": "sinkhorn_eps",
    "sinkhorn_l": "sinkhorn_l", "scaling_coef": "scaling_coef",
    "reg_penalty": "reg_penalty", "cost_method": "cost_method",
    "solver": "sinkhorn_solver", "compute_dtype": "compute_dtype",
    "kernel": "kernel", "kernel_impl": "kernel_impl",
    "init_sigma": "init_sigma", "decaying_sigma": "decaying_sigma",
    "lr": "lr", "warmup": "warmup_steps", "num_devices": "num_devices", "seq_devices": "seq_devices",
    "seed": "seed", "save_freq": "save_freq", "ckpt_freq": "ckpt_freq",
    "nan_recovery_retries": "nan_recovery_retries",
    "out_dir": "out_dir", "run_name": "run_name", "checkpoint": "checkpoint",
    "ckpt_path": "ckpt_path",
}

_SENTINEL = object()


def provided_dests(parser: argparse.ArgumentParser, argv) -> set[str]:
    """The dests typed on the command line: ``argv`` parsed again into a
    namespace that holds a sentinel for every dest, which argparse leaves
    in place for every flag not typed."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ns = argparse.Namespace()
    for action in parser._actions:
        if action.dest is not argparse.SUPPRESS:
            setattr(ns, action.dest, _SENTINEL)
    parser.parse_args(argv, ns)
    return {
        action.dest
        for action in parser._actions
        if action.dest is not argparse.SUPPRESS and getattr(ns, action.dest, _SENTINEL) is not _SENTINEL
    }


def config_from_args(args: argparse.Namespace, provided: set[str] | None = None) -> TrainConfig:
    """The run's config: the preset with the typed flags laid over it, or,
    without a preset, every flag's value."""
    if args.preset:
        base = get_preset(args.preset)
        # run-identity flags always apply; any other only when typed
        sel = (provided or set()) | {"data_path", "out_dir", "run_name", "seed"}
        model_over = {f: getattr(args, d) for d, f in _MODEL_DESTS.items() if d in sel}
        if "height" in sel:
            model_over["z_height"] = max(args.height // 16, 1)
        if "width" in sel:
            model_over["z_width"] = max(args.width // 16, 1)
        train_over = {f: getattr(args, d) for d, f in _TRAIN_DESTS.items() if d in sel}
        if "local_sinkhorn" in sel:
            train_over["global_batch_sinkhorn"] = not args.local_sinkhorn
        model = dataclasses.replace(base.model, **model_over) if model_over else base.model
        return dataclasses.replace(base, model=model, **train_over)
    if [int(x) for x in args.dec_period.split(",")][-1] != 1:
        # the reference's decoder crashes for any other value too
        raise SystemExit("dec_period[-1] != 1 is unsupported")
    model = ModelConfig(
        x_height=args.height,
        x_width=args.width,
        n_channels=args.n_channels,
        d_state_size=args.d_state_size,
        g_filter_size=args.g_filter_size,
        d_filter_size=args.d_filter_size,
        z_channels=args.z_channels,
        z_height=max(args.height // 16, 1),
        z_width=max(args.width // 16, 1),
        use_norm=args.batch_norm,
        dropout=args.dropout,
        rnn_dropout=args.rnn_dropout,
    )
    return TrainConfig(model=model, global_batch_sinkhorn=not args.local_sinkhorn,
                       **{f: getattr(args, d) for d, f in _TRAIN_DESTS.items()})


def _check_mesh(parser, cfg, joined: int) -> None:
    """An argparse error unless the mesh flags fit the config and the
    host: at least one rank an axis, times and batch divisible, and (when
    this process spawns them) no more ranks than CPU cores."""
    from ..parallel.seqtrain import check_seq_config

    n, s = cfg.num_devices, cfg.seq_devices
    if n < 1 or s < 1:
        parser.error(f"--num_devices {n} --seq_devices {s}: each needs at least one rank")
    cores = os.cpu_count() or 1
    if joined == 1 and n * s > cores:
        parser.error(f"--num_devices {n} x --seq_devices {s} = {n * s} ranks: this host runs at most {cores}, "
                     "one process a CPU core")
    if joined > 1 and joined != n * s:
        parser.error(f"--num_devices {n} x --seq_devices {s} = {n * s} ranks, the job has {joined}")
    if s > 1 and not cfg.global_batch_sinkhorn:
        parser.error("--local_sinkhorn is a data-parallel mode; the sequence-parallel step solves the global batch")
    try:
        check_seq_config(cfg, s, n)
    except ValueError as e:
        parser.error(str(e))


def _train(cfg, args, device) -> dict:
    """Train this process's part of the run: on ``device`` alone, or as
    this rank of the job's mesh.  Returns the summary (rank 0's names
    the mesh)."""
    from ..data import make_dataset
    from ..parallel.mesh import data_seq_mesh, make_mesh
    from ..train import Trainer

    mesh = seq = None
    if cfg.seq_devices > 1:
        seq = data_seq_mesh(cfg.num_devices, cfg.seq_devices, device=device)
    elif cfg.num_devices > 1:
        mesh = make_mesh(cfg.num_devices, device=device)
    trainer = Trainer(cfg, device=device, mesh=mesh, seq_mesh=seq)
    batches, test_batch = make_dataset(cfg)
    profile_steps = None
    if args.profile_steps:
        a, b = args.profile_steps.split(",")
        profile_steps = (int(a), int(b))
    _, summary = trainer.fit(
        batches, max_steps=args.max_steps, test_batch=test_batch, profile_steps=profile_steps
    )
    on = mesh or seq
    summary.update(num_devices=cfg.num_devices, seq_devices=cfg.seq_devices,
                   global_batch_sinkhorn=cfg.global_batch_sinkhorn, dist_backend=on.backend if on else None)
    return summary


def _train_rank(rank: int, device, argv) -> dict | None:
    """One spawned rank of ``main``: its part of the run; rank 0's summary."""
    parser = build_parser()
    args = parser.parse_args(argv)
    summary = _train(config_from_args(args, provided_dests(parser, argv)), args, device)
    return summary if rank == 0 else None


def main(argv: list[str] | None = None, *, device="cuda") -> int:
    """Train as the flags say on ``device`` (each rank on its own under a
    mesh), print the summary as one JSON line (rank 0's), and return 0 if
    the run completed, else 1."""
    from ..parallel.launch import run_ranks
    from ..parallel.mesh import initialize_multihost

    parser = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    cfg = config_from_args(args, provided_dests(parser, argv))
    joined = initialize_multihost(device)
    _check_mesh(parser, cfg, joined)
    ranks = cfg.num_devices * cfg.seq_devices
    if joined > 1:  # started by torchrun: this process is one rank
        import torch

        dev = torch.device("cpu") if torch.device(device).type == "cpu" else torch.device(
            "cuda", torch.cuda.current_device())
        summary = _train(cfg, args, dev)
        if torch.distributed.get_rank() != 0:
            return 0 if summary["status"] == "completed" else 1
    elif ranks > 1:
        cpu = str(device) == "cpu"
        summary = run_ranks(_train_rank, ranks, (argv,), device=device, threads=1 if cpu else None,
                            timeout=24 * 3600)[0]
    else:
        summary = _train(cfg, args, device)
    print(json.dumps(summary))
    return 0 if summary["status"] == "completed" else 1


if __name__ == "__main__":
    sys.exit(main())
