"""Offline visualization utilities over plain numpy.

The port's own copy of ``kccotgan_tpu/utils/viz.py`` (it imports nothing
of the JAX package): low-dimensional series plots, film-strip frame
grids, and sample-grid video export, with the capability of the
reference TF2 implementation's notebook helpers (its ``data_utils.py``).

* All functions take plain numpy and explicit output paths, and run on
  the host only; nothing here touches torch.
* The grid assembly is a pure function (``video_grid``); writers exist
  for GIF (PIL, imported inside ``save_video_gif``) and HTML
  (matplotlib's jshtml, returned as a string, no IPython).
* matplotlib is imported lazily with the Agg backend, so importing
  ``kccotgan_tpu_torch.utils`` never requires matplotlib or a display.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "save_low_d",
    "display_frames",
    "video_grid",
    "samples_to_video",
    "save_video_gif",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def save_low_d(
    data: np.ndarray,
    out_path: str,
    input_len: int = 25,
    row: int = 4,
    col: int = 4,
) -> str:
    """Grid of 1-D time series, context steps cyan / predicted red.

    Reference: `data_utils.py:208-247` (LineCollection with a per-step
    ListedColormap; x ticks at 1 / input_len / ts on the bottom row).

    Args:
      data: ``[B, T, 1]`` or ``[B, T]`` series batch (B >= row*col).
      out_path: PNG path to write (parent dirs created).
    """
    plt = _plt()
    from matplotlib.collections import LineCollection
    from matplotlib.colors import ListedColormap

    data = np.asarray(data)
    if data.ndim == 2:
        data = data[..., None]
    bs, ts, _ = data.shape
    if bs < row * col:
        raise ValueError(f"need {row * col} series, got batch {bs}")
    x = np.arange(ts)
    cmap = ListedColormap(["c" if i < input_len - 1 else "r" for i in range(ts)])

    fig, axs = plt.subplots(row, col, figsize=(12, 6), squeeze=False)
    n = 0
    for r in range(row):
        for c in range(col):
            pts = np.stack([x, data[n, :, 0]], axis=1).reshape(-1, 1, 2)
            segs = np.concatenate([pts[:-1], pts[1:]], axis=1)
            lc = LineCollection(segs, cmap=cmap, linewidth=2)
            lc.set_array(x)
            axs[r][c].add_collection(lc)
            axs[r][c].autoscale_view()
            n += 1
            if r == row - 1:
                axs[r][c].set_xticks([0, input_len - 1, ts - 1])
                axs[r][c].set_xticklabels(["1", str(input_len), str(ts)])
                axs[r][c].set_xlabel("t")
                axs[r][c].set(frame_on=False)
            else:
                axs[r][c].axis("off")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def display_frames(
    x: np.ndarray,
    out_path: str,
    rows: int = 4,
    *,
    seed: int | None = None,
) -> str:
    """Film-strip PNG grid: `rows` random samples, frames tiled along W.

    Reference: `data_utils.py:250-265`.  Accepts ``[B, H, T, W, C]`` or
    already-flat ``[B, H, T*W, C]`` film strips; C in {1, 3}.
    """
    plt = _plt()
    x = np.asarray(x)
    if x.ndim == 5:
        b, h, t, w, c = x.shape
        x = x.reshape(b, h, t * w, c)
    b, h, tw, c = x.shape
    rng = np.random.default_rng(seed)
    fig, axes = plt.subplots(rows, figsize=(8, 8), squeeze=False)
    for i in range(rows):
        img = x[rng.integers(0, b)]
        axes[i][0].imshow(
            img if c > 1 else img[..., 0],
            origin="upper", cmap="gray", interpolation="nearest",
        )
        axes[i][0].set_xticks([])
        axes[i][0].set_yticks([])
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def video_grid(
    samples: np.ndarray,
    nx: int,
    ny: int,
    time_steps: int = 16,
    x_height: int = 64,
    x_width: int = 64,
) -> np.ndarray:
    """Assemble an ``nx x ny`` sample grid into video frames.

    Pure-numpy core of the reference's `samples_to_video`
    (`data_utils.py:452-456`): film-strip samples -> ``[T, nx*H, ny*W, C]``
    (C clipped to <= 3)."""
    s = np.asarray(samples).reshape(nx, ny, x_height, time_steps, x_width, -1)
    s = np.concatenate(s, 1)  # [ny, H, nx*T? ...] — matches reference order
    s = np.concatenate(s, 2)
    s = np.transpose(s, [1, 0, 2, 3])[..., :3]
    return s


def samples_to_video(
    samples: np.ndarray,
    nx: int,
    ny: int,
    time_steps: int = 16,
    x_height: int = 64,
    x_width: int = 64,
    interval_ms: int = 100,
):
    """Matplotlib jshtml animation of a sample grid (reference
    `data_utils.py:452-475`).  Returns the HTML string (no IPython
    dependency — wrap in ``IPython.display.HTML`` yourself if in a
    notebook)."""
    plt = _plt()
    from matplotlib import animation

    frames = video_grid(samples, nx, ny, time_steps, x_height, x_width)
    fig, ax = plt.subplots(figsize=(ny, nx))
    im = ax.imshow(np.squeeze(frames[0]))
    ax.set_axis_off()
    fig.tight_layout()

    def animate(i):
        im.set_data(np.squeeze(frames[i]))
        return (im,)

    anim = animation.FuncAnimation(
        fig, animate, frames=time_steps, interval=interval_ms, blit=True
    )
    html = anim.to_jshtml()
    plt.close(fig)
    return html


def save_video_gif(
    samples: np.ndarray,
    out_path: str,
    nx: int,
    ny: int,
    time_steps: int = 16,
    x_height: int = 64,
    x_width: int = 64,
    fps: int = 10,
) -> str:
    """Write the sample grid as a GIF (the reference repo ships its
    results as gifs — `README.md:9-16`)."""
    from PIL import Image

    frames = video_grid(samples, nx, ny, time_steps, x_height, x_width)
    frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    imgs = [Image.fromarray(f) for f in frames]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    imgs[0].save(
        out_path, save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0,
    )
    return out_path
