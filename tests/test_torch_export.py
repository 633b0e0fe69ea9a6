"""The port's serving export (``kccotgan_tpu_torch/export.py``,
``cli/export.py``) on the CPU.

The contract of ``tests/test_export.py`` for the port's artifact: one
self-contained file, weights baked in, the batch symbolic, the same
video for the same (context, seed).  The artifact must reproduce the
live rollout bit for bit: the exported program runs the aten operators
the live rollout runs, undecomposed, and each ConvLSTM recurrence as the
registered operator ``kccot::convlstm_fwd`` (its CPU implementation the
plain recurrence), so no tolerance.  The geometry is
``test_torch_loop.py``'s (B=2, 16x16, g_filter_size 2) with 3 + 2
frames, in the presets' compute dtype (bf16 convs).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kccotgan_tpu_torch import config as port_config
from kccotgan_tpu_torch.ckpt import save_checkpoint
from kccotgan_tpu_torch.cli import export as export_cli
from kccotgan_tpu_torch.config import ModelConfig, TrainConfig
from kccotgan_tpu_torch.export import _FORMAT_VERSION, _MAGIC, load_rollout, save_rollout
from kccotgan_tpu_torch.train import build_rollout, create_train_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CFG = TrainConfig(
    dname="synthetic", batch_size=2, total_time_steps=5, int_time_steps=3, sinkhorn_l=3,
    model=ModelConfig(x_height=16, x_width=16, g_filter_size=2, d_filter_size=1, d_state_size=2,
                      z_channels=4, z_height=1, z_width=1),
)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A symbolic-batch artifact of the seeded state, and it loaded."""
    state = create_train_state(CFG, device="cpu")
    path = tmp_path_factory.mktemp("export") / "model.kccot"
    header = save_rollout(str(path), CFG, state, device="cpu")
    return path, header, state, load_rollout(str(path))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``cli.export --batch 2 --check`` on a checkpoint of the seeded state,
    through a throwaway preset holding the tiny config."""
    root = tmp_path_factory.mktemp("export_cli")
    save_checkpoint(str(root / "ckpt"), create_train_state(CFG, device="cpu"))
    port_config.PRESETS["_export_tiny"] = CFG
    try:
        rc = export_cli.main(["--preset", "_export_tiny", "--ckpt", str(root / "ckpt"),
                              "--out", str(root / "static.kccot"), "--batch", "2", "--check"], device="cpu")
    finally:
        port_config.PRESETS.pop("_export_tiny")
    return root, rc


def _context(batch, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(batch, 16, 3, 16, 1).astype("float32"))


def test_header_contract(artifact):
    path, header, _, serve = artifact
    assert header["format_version"] == _FORMAT_VERSION
    assert header["platforms"] == ["cpu"] and header["device"] == "cpu"
    assert header["context_shape"] == ["b", "16", "3", "16", "1"]
    assert header["z_shape"] == ["2", "b", "1", "1", "1", "4"]
    assert header["context_time_steps"] == 3 and header["output_time_steps"] == 5
    assert (header["height"], header["width"], header["channels"]) == (16, 16, 1)
    assert header["step"] == 0 and header["compute_dtype"] == "bfloat16"
    assert header["torch_version"] == torch.__version__
    assert serve.header == header and serve.platforms == ("cpu",)
    with open(path, "rb") as f:
        assert f.read(len(_MAGIC)) == _MAGIC


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_roundtrip_bit_exact_vs_live_rollout(artifact, batch):
    """One symbolic artifact at B = 1, 2 and 3 against the live rollout on
    the artifact's noise."""
    _, _, state, serve = artifact
    ctx = _context(batch, seed=batch)
    got = serve(ctx, seed=7)
    params = {"encoder": state.enc_params, "decoder": state.dec_params}
    want = build_rollout(CFG, device="cpu")(params, ctx, z=serve.noise(batch, seed=7))
    assert got.shape == (batch, 16, 5, 16, 1)
    assert torch.equal(got, want)
    assert torch.equal(got[:, :, :3], ctx)


def test_seed_determinism(artifact):
    serve = artifact[3]
    ctx = _context(2)
    assert torch.equal(serve(ctx, seed=3), serve(ctx, seed=3))
    assert torch.equal(serve(ctx.numpy(), seed=3), serve(ctx, seed=3))
    assert not torch.equal(serve(ctx, seed=3), serve(ctx, seed=4))


def test_program_runs_each_recurrence_as_the_operator(artifact):
    """4 encoder layers over the context, then 8 ConvLSTM layers a predicted
    frame, each one ``kccot::convlstm_fwd`` node; the only sigmoid left is
    the decoder's output activation, one a frame (a traced plain
    recurrence would add three a step)."""
    graph = artifact[3]._module.graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets.count("kccot.convlstm_fwd.default") == 4 + 8 * CFG.pred_time_steps
    assert targets.count("aten.sigmoid.default") == CFG.pred_time_steps


def _rewrite(path, out, magic=None, **header_changes):
    blob = Path(path).read_bytes()
    n = int.from_bytes(blob[8:12], "little")
    header = json.loads(blob[12:12 + n])
    header.update(header_changes)
    new = json.dumps(header).encode()
    out.write_bytes((magic or blob[:8]) + len(new).to_bytes(4, "little") + new + blob[12 + n:])
    return str(out)


@pytest.mark.parametrize("magic,changes,match", [
    (b"NOTKCCOT", {}, "bad magic"),
    (b"KCCOTEXP", {}, "a JAX artifact"),
    (None, {"format_version": _FORMAT_VERSION + 1}, "unsupported format_version"),
], ids=["bad_magic", "jax_magic", "format_version"])
def test_refuses_foreign_files(artifact, tmp_path, magic, changes, match):
    with pytest.raises(ValueError, match=match):
        load_rollout(_rewrite(artifact[0], tmp_path / "x.kccot", magic, **changes))


def test_cuda_artifact_without_a_card_raises(artifact, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_rollout(_rewrite(artifact[0], tmp_path / "cuda.kccot", device="cuda", platforms=["cuda"]))


def test_cli_export_check_passes(cli_run, artifact):
    root, rc = cli_run
    assert rc == 0
    serve = load_rollout(str(root / "static.kccot"))
    assert serve.header["context_shape"] == ["2", "16", "3", "16", "1"]
    ctx = _context(2)
    assert torch.equal(serve(ctx, seed=1), artifact[3](ctx, seed=1))  # the same weights, seed and noise


def test_cli_export_refuses_platforms(capsys):
    with pytest.raises(SystemExit) as e:
        export_cli.main(["--ckpt", "x", "--platforms", "cpu,tpu"], device="cpu")
    assert e.value.code == 2
    assert "exported on" in capsys.readouterr().err


def test_subprocess_serves_from_the_file_alone(cli_run, artifact, tmp_path):
    """A fresh process given only the artifact's path loads and runs it,
    and imports neither JAX nor the JAX package."""
    path = cli_run[0] / "static.kccot"
    ctx = _context(2, seed=5)
    np.save(tmp_path / "ctx.npy", ctx.numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "from kccotgan_tpu_torch.export import load_rollout\n"
        "torch.set_num_threads(1)\n"
        "serve = load_rollout(sys.argv[1])\n"
        "np.save(sys.argv[3], serve(np.load(sys.argv[2]), seed=2).numpy())\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'kccotgan_tpu')]\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, str(path), str(tmp_path / "ctx.npy"), str(tmp_path / "out.npy")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), artifact[3](ctx, seed=2).numpy())
