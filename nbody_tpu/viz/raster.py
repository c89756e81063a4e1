"""Device-side point rasterizer — the headless replacement for the
reference's OpenGL pipeline (``simulation_visualization.cpp``).

The reference renders bodies as GL_POINTS through a CUDA<->GL interop VBO so
positions never leave the device (``simulation_visualization.cpp:172-223``);
its vertex shader maps positions into NDC by dividing by +/-MAX_VIEW* and
mass into a [0,1] weight (``.cpp:27-37``), and its fragment shader colors
each point by lerping green->red with that weight (``.cpp:46-56``).

The rebuild keeps the same zero-copy spirit: a jitted
scatter-based point splat runs *on device* over the simulation's own arrays
(no host round-trip of the body set), producing a small RGB frame that is the
only thing streamed to the host.  Orthographic projection drops the axis
``view_axis`` (default z, matching the reference's fixed unrotated camera —
its model/view matrices are commented out, ``.cpp:196-214``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Defaults matching simulation_visualization.h:8-9 and constants.h:15-23
DEFAULT_WIDTH = 800
DEFAULT_HEIGHT = 600


@functools.partial(
    jax.jit, static_argnames=("width", "height", "view_axis"))
def render_weights(pos: jax.Array, mass: jax.Array,
                   min_mass: float, max_mass: float, max_view: float,
                   width: int = DEFAULT_WIDTH, height: int = DEFAULT_HEIGHT,
                   view_axis: int = 2,
                   cu: float = 0.0, cv: float = 0.0) -> jax.Array:
    """Rasterize bodies to a PACKED (H, W) uint8 weight map on device:
    0 = background, 1..255 = quantized mass weight (the fragment shader's
    [0,1] lerp parameter).  One byte/pixel instead of three — the frame
    stream is device->host traffic, and color is a deterministic 1-D
    function of weight, so frames ship packed and
    colorize host-side (``colorize``) with identical pixels.

    Where several bodies land on one pixel the max weight wins (a
    depth-less brightest-point rule standing in for GL's last-write;
    deterministic, unlike the reference).  Zero-mass ghosts never draw.

    ``max_view``/``cu``/``cv`` are TRACED scalars: the live viewer's
    zoom (smaller max_view) and pan (world-space view center on the two
    projected axes) change per call with zero recompilation.
    """
    axes = [a for a in range(3) if a != view_axis]
    u = (pos[:, axes[0]] - cu) / max_view   # NDC x in [-1, 1]
    v = (pos[:, axes[1]] - cv) / max_view   # NDC y
    # Weight in [0,1] like the vertex shader (simulation_visualization.cpp:33)
    weight = jnp.clip((mass - min_mass) / (max_mass - min_mass), 0.0, 1.0)

    px = ((u + 1.0) * 0.5 * (width - 1)).astype(jnp.int32)
    py = ((1.0 - (v + 1.0) * 0.5) * (height - 1)).astype(jnp.int32)
    inside = ((u >= -1.0) & (u <= 1.0) & (v >= -1.0) & (v <= 1.0)
              & (mass > 0.0))

    flat_idx = jnp.where(inside, py * width + px, width * height)
    # 1 + w*254 keeps any real body above the 0 background sentinel.
    w8 = (weight * 254.0 + 1.5).astype(jnp.uint8)   # 1..255
    splat = jnp.zeros((width * height + 1,), jnp.uint8).at[flat_idx].max(
        jnp.where(inside, w8, jnp.uint8(0)))
    return splat[:-1].reshape(height, width)


def _weight_lut() -> np.ndarray:
    """(256, 3) uint8 LUT: index 0 = background (black), 1..255 = the
    fragment shader's mix(green, red, w) (simulation_visualization.cpp:46-56)
    with w = (k-1)/254."""
    k = np.arange(256, dtype=np.float32)
    w = np.clip((k - 1.0) / 254.0, 0.0, 1.0)
    lut = np.stack([w, 1.0 - w, np.zeros_like(w)], axis=-1)
    lut = (lut * 255.0 + 0.5).astype(np.uint8)
    lut[0] = 0
    return lut


_LUT = _weight_lut()


def colorize(weights) -> np.ndarray:
    """Host-side (H, W) uint8 weight map -> (H, W, 3) uint8 RGB."""
    return _LUT[np.asarray(weights)]


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "view_axis"))
def render_frame(pos: jax.Array, mass: jax.Array,
                 min_mass: float, max_mass: float, max_view: float,
                 width: int = DEFAULT_WIDTH, height: int = DEFAULT_HEIGHT,
                 view_axis: int = 2,
                 cu: float = 0.0, cv: float = 0.0) -> jax.Array:
    """Rasterize bodies to an (H, W, 3) uint8 RGB frame on device.

    Color: green->red lerp by normalized mass weight, exactly the fragment
    shader's ``mix(green, red, weight)`` (simulation_visualization.cpp:46-56).
    Bodies outside the +/-max_view box clip out (NDC clip behavior).
    Pixels are identical to ``colorize(render_weights(...))`` — this is the
    on-device colorized variant for consumers that want RGB directly.
    """
    w8 = render_weights(pos, mass, min_mass, max_mass, max_view,
                        width, height, view_axis, cu, cv)
    return jnp.asarray(_LUT)[w8]
