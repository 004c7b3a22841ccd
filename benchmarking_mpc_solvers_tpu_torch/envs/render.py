"""Environment rendering.

Counterpart of ``benchmarking_mpc_solvers_tpu/envs/render.py``, with the same
pixels: each call renders one state to an RGB uint8 frame with matplotlib
(the Agg backend, headless), and ``render_episode`` strings frames into an
animated GIF with PIL. matplotlib and PIL are loaded on first use, so that
importing the package needs neither. States may be tensors on any device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..device import to_numpy


def _plt():
    """matplotlib's pyplot on the Agg backend, loaded on first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _fig_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    return buf.reshape(h, w, 4)[..., :3].copy()


def render_pendulum(state, last_u: Optional[float] = None, size: float = 2.2):
    """Rod + axle + torque arrow; theta=0 is upright (reference convention)."""
    plt = _plt()
    th = float(state[0])
    fig, ax = plt.subplots(figsize=(3, 3), dpi=64)
    ax.set_xlim(-size, size)
    ax.set_ylim(-size, size)
    ax.set_aspect("equal")
    ax.axis("off")
    x, y = np.sin(th), np.cos(th)
    ax.plot([0, x], [0, y], lw=6, color="#cc4444", solid_capstyle="round")
    ax.add_patch(plt.Circle((0, 0), 0.07, color="#333333"))
    if last_u:
        mag = np.clip(abs(float(last_u)) / 2.0, 0.1, 1.0)
        ang = np.linspace(0, 4.0 * mag, 30) * np.sign(-float(last_u))
        ax.plot(0.4 * np.cos(ang), 0.4 * np.sin(ang), lw=2, color="#4477cc")
    frame = _fig_to_rgb(fig)
    plt.close(fig)
    return frame


def render_cartpole(state, last_u: Optional[float] = None):
    """Cart with wheels + pole; x limits at the ±2.4 done threshold."""
    plt = _plt()
    xc, _, th, _ = (float(v) for v in state[:4])
    fig, ax = plt.subplots(figsize=(4, 3), dpi=64)
    ax.set_xlim(-2.8, 2.8)
    ax.set_ylim(-1.0, 1.6)
    ax.set_aspect("equal")
    ax.axis("off")
    ax.axhline(0.0, color="#999999", lw=1)
    for thr in (-2.4, 2.4):
        ax.axvline(thr, color="#cc8888", lw=1, linestyle="--")
    cart_w, cart_h = 0.4, 0.2
    ax.add_patch(plt.Rectangle((xc - cart_w / 2, 0.05), cart_w, cart_h, color="#333366"))
    for dx in (-0.12, 0.12):
        ax.add_patch(plt.Circle((xc + dx, 0.05), 0.05, color="#222222"))
    L = 0.6
    tip = (xc + L * np.sin(th), 0.05 + cart_h + L * np.cos(th))
    ax.plot([xc, tip[0]], [0.05 + cart_h, tip[1]], lw=4, color="#cc8833",
            solid_capstyle="round")
    frame = _fig_to_rgb(fig)
    plt.close(fig)
    return frame


def render_acrobot(state, last_u: Optional[float] = None):
    """Two links; theta=0 hanging down (reference convention); goal line at
    tip height 1 (the done threshold)."""
    plt = _plt()
    t1, t2 = float(state[0]), float(state[1])
    fig, ax = plt.subplots(figsize=(3, 3), dpi=64)
    ax.set_xlim(-2.3, 2.3)
    ax.set_ylim(-2.3, 2.3)
    ax.set_aspect("equal")
    ax.axis("off")
    ax.axhline(1.0, color="#88cc88", lw=1, linestyle="--")
    p1 = (np.sin(t1), -np.cos(t1))
    p2 = (p1[0] + np.sin(t1 + t2), p1[1] - np.cos(t1 + t2))
    ax.plot([0, p1[0]], [0, p1[1]], lw=5, color="#4466aa", solid_capstyle="round")
    ax.plot([p1[0], p2[0]], [p1[1], p2[1]], lw=5, color="#aa6644",
            solid_capstyle="round")
    ax.add_patch(plt.Circle((0, 0), 0.06, color="#333333"))
    ax.add_patch(plt.Circle(p1, 0.06, color="#333333"))
    frame = _fig_to_rgb(fig)
    plt.close(fig)
    return frame


RENDERERS = {
    "PendulumEnvironment": render_pendulum,
    "CartpoleSwingupEnvironment": render_cartpole,
    "AcrobotEnvironment": render_acrobot,
    "pendulum": render_pendulum,
    "cartpole_swingup": render_cartpole,
    "acrobot": render_acrobot,
}


def render_state(env_name: str, state, last_u: Optional[float] = None) -> np.ndarray:
    return RENDERERS[env_name](to_numpy(state), last_u)


def render_episode(
    env_name: str,
    states: Sequence,
    actions: Optional[Sequence] = None,
    path: Optional[str] = None,
    fps: int = 20,
    stride: int = 1,
):
    """Render a trajectory; optionally write an animated GIF via pillow."""
    frames = []
    for i in range(0, len(states), stride):
        u = None
        if actions is not None and i < len(actions):
            u = float(to_numpy(actions[i]).ravel()[0])
        frames.append(render_state(env_name, states[i], u))
    if path is not None:
        try:
            from PIL import Image

            imgs = [Image.fromarray(f) for f in frames]
            imgs[0].save(
                path, save_all=True, append_images=imgs[1:],
                duration=int(1000 / fps), loop=0,
            )
        except ImportError:
            # no pillow: dump per-frame PNGs next to the requested path
            import pathlib

            base = pathlib.Path(path).with_suffix("")
            base.mkdir(parents=True, exist_ok=True)
            for i, f in enumerate(frames):
                _plt().imsave(base / f"frame_{i:04d}.png", f)
    return frames
