"""Serving export: the rollout as one self-contained ``torch.export`` artifact.

Counterpart of ``kccotgan_tpu/export.py``.  ``torch.export`` captures
``train.rollout.RolloutModule`` holding the trained encoder's and
decoder's weights, with the context's batch symbolic
(``torch.export.Dim("b")``) unless a static batch is asked for, into one
file.  Any process of the same PyTorch installation deserializes it and
serves conditioned video predictions, with no checkpoint, no config and
no model code beyond the ConvLSTM forward's registered operator
(``torch.ops.kccot.convlstm_fwd``, which importing this module
registers):

    from kccotgan_tpu_torch.export import save_rollout, load_rollout
    save_rollout("model.kccot", cfg, state)          # once, after training
    serve = load_rollout("model.kccot")              # the card it was exported on
    video = serve(context, seed=0)                   # [B, H, Tc + Tp, W, C]

Design notes:

* The program's inputs are ``(context [B, H, Tc, W, C] f32, z [Tp, B, 1,
  z_h, z_w, z_c] f32)``: a generator cannot be exported.
  ``ServingRollout(context, seed)`` draws ``z`` from
  ``torch.Generator(device).manual_seed(seed)`` as the live rollout draws
  it (``draw_noise``), so an identical (context, seed) pair gives an
  identical video.
* The ConvLSTM recurrences stay one operator each, whose CUDA
  implementation launches the forward kernel once a step and whose fake
  implementation keeps the batch symbolic.  The program is not
  decomposed (no ``run_decompositions``): it runs the aten operators the
  live rollout runs, so it reproduces it bit for bit on the same device.
* The artifact runs on the device it was exported on: the card by
  default, or the CPU when the caller asks.  JAX's ``platforms=("cpu",
  "tpu")`` has no counterpart here: an exported program holds its weights
  and device placements for one device type.  On the card,
  ``ServingRollout`` replays the program from one CUDA graph per batch
  size (``train.graph.GraphReplay``).
* Artifacts are made and loaded within one PyTorch installation: the
  header records ``torch_version``, and ``load_rollout`` refuses another
  ``format_version``; loading across PyTorch versions is not promised.

File layout (JAX's, with the port's own magic): 8-byte magic, u32
little-endian header length, JSON header, then the ``torch.export.save``
bytes.  The header carries JAX's fields (``format_version``,
``platforms``, ``context_shape``, ``output_time_steps``,
``context_time_steps``, ``height``, ``width``, ``channels``, ``step``)
and ``device``, ``torch_version``, ``compute_dtype`` and ``z_shape``.
"""

from __future__ import annotations

import io
import json
import os

import torch

from .models import cuda_convlstm  # noqa: F401  (registers kccot::convlstm_fwd)
from .train.graph import GraphReplay
from .train.rollout import RolloutModule, draw_noise, module_weights

__all__ = ["export_rollout", "save_rollout", "load_rollout", "ServingRollout"]

_MAGIC = b"KCCOTPT2"
_JAX_MAGIC = b"KCCOTEXP"  # kccotgan_tpu.export's jax.export artifacts
_FORMAT_VERSION = 1
# The example batch of a symbolic export: tracing at 0 or 1 would
# specialise the batch.
_TRACE_BATCH = 2


def export_rollout(cfg, state, *, batch_polymorphic: bool = True, batch_size: int | None = None,
                   device="cuda") -> torch.export.ExportedProgram:
    """Export the rollout for ``state``'s weights (``enc_params``,
    ``dec_params``) on ``device``.  ``batch_polymorphic=True`` exports a
    symbolic batch; otherwise ``batch_size`` (default ``cfg.batch_size``)
    is baked in."""
    device = torch.device(device)
    m = cfg.model
    with torch.device("meta"):
        module = RolloutModule(cfg)
    weights = {k: v.to(device) for k, v in module_weights(
        {"encoder": state.enc_params, "decoder": state.dec_params}).items()}
    module.load_state_dict(weights, strict=True, assign=True)
    module.requires_grad_(False)
    b = _TRACE_BATCH if batch_polymorphic else batch_size or cfg.batch_size
    context = torch.zeros(b, m.x_height, cfg.int_time_steps, m.x_width, m.n_channels, device=device)
    z = torch.zeros(cfg.pred_time_steps, b, 1, m.z_height, m.z_width, m.z_channels, device=device)
    dynamic = None
    if batch_polymorphic:
        batch = torch.export.Dim("b", min=1)
        dynamic = {"context": {0: batch}, "z": {1: batch}}
    with torch.no_grad():
        return torch.export.export(module, (context, z), dynamic_shapes=dynamic, strict=False)


def save_rollout(path: str, cfg, state, *, batch_polymorphic: bool = True, batch_size: int | None = None,
                 device="cuda") -> dict:
    """Export (``export_rollout``'s arguments) and write the artifact;
    returns its JSON header."""
    program = export_rollout(cfg, state, batch_polymorphic=batch_polymorphic, batch_size=batch_size,
                             device=device)
    device = torch.device(device).type
    m = cfg.model
    b = "b" if batch_polymorphic else str(batch_size or cfg.batch_size)
    header = {
        "format_version": _FORMAT_VERSION,
        "platforms": [device],
        "context_shape": [b, *map(str, (m.x_height, cfg.int_time_steps, m.x_width, m.n_channels))],
        "output_time_steps": cfg.int_time_steps + cfg.pred_time_steps,
        "context_time_steps": cfg.int_time_steps,
        "height": m.x_height,
        "width": m.x_width,
        "channels": m.n_channels,
        "step": int(getattr(state, "step", 0)),
        "device": device,
        "torch_version": torch.__version__,
        "compute_dtype": cfg.compute_dtype,
        "z_shape": [str(cfg.pred_time_steps), b, *map(str, (1, m.z_height, m.z_width, m.z_channels))],
    }
    payload = io.BytesIO()
    torch.export.save(program, payload)
    blob = json.dumps(header).encode("utf-8")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(len(blob).to_bytes(4, "little"))
        f.write(blob)
        f.write(payload.getvalue())
    return header


class ServingRollout:
    """Deserialized artifact: ``serve(context, seed=0) -> video``.

    ``context``: film-strip ``[B, H, Tc, W, C]`` float32 (any B if the
    artifact was exported with a symbolic batch), moved to the artifact's
    ``device``.  Purely functional: identical (context, seed) pairs give
    identical videos.  ``noise(batch, seed)`` is the ``z`` a call draws,
    ``run(context, z)`` the program on it, eagerly.
    """

    def __init__(self, header: dict, program: torch.export.ExportedProgram):
        self.header = header
        self.device = torch.device(header["device"])
        self._module = program.module()
        self._replay = GraphReplay(self.run) if self.device.type == "cuda" else None

    @property
    def platforms(self) -> tuple:
        return tuple(self.header["platforms"])

    def noise(self, batch: int, seed: int = 0) -> torch.Tensor:
        steps, _, *rest = self.header["z_shape"]
        generator = torch.Generator(self.device).manual_seed(seed)
        return draw_noise(generator, int(steps), (batch, *map(int, rest)), self.device)

    def run(self, context: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._module(context, z)

    def __call__(self, context, seed: int = 0) -> torch.Tensor:
        context = torch.as_tensor(context, dtype=torch.float32).to(self.device)
        z = self.noise(context.shape[0], seed)
        return self.run(context, z) if self._replay is None else self._replay(context, z)


def load_rollout(path: str) -> ServingRollout:
    """Load an artifact written by :func:`save_rollout`: needs only torch
    and the operator this module registers."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _JAX_MAGIC:
            raise ValueError(
                f"{path}: a JAX artifact (jax.export, kccotgan_tpu.export); "
                "load it with kccotgan_tpu.export.load_rollout"
            )
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a kccotgan_tpu_torch export artifact (bad magic {magic!r})")
        n = int.from_bytes(f.read(4), "little")
        header = json.loads(f.read(n).decode("utf-8"))
        if header.get("format_version") != _FORMAT_VERSION:
            raise ValueError(f"{path}: unsupported format_version {header.get('format_version')}")
        if header["device"] == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path}: exported for cuda, and there is no CUDA device")
        program = torch.export.load(io.BytesIO(f.read()))
    return ServingRollout(header, program)
