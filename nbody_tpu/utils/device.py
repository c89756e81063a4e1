"""Device introspection — the analog of ``print_device_prop``
(``utils.cpp:49-68``), reporting what JAX exposes of each device: kind,
platform and device memory."""

from __future__ import annotations

import jax


def kernel_available() -> bool:
    """True when the tiled Pallas kernel compiles for this process's
    default device (the GPU, through Triton)."""
    return jax.default_backend() == "gpu"


def device_info() -> "list[dict]":
    infos = []
    for d in jax.devices():
        info = {
            "id": d.id,
            "platform": d.platform,
            "device_kind": getattr(d, "device_kind", "unknown"),
            "process_index": d.process_index,
        }
        try:
            stats = d.memory_stats() or {}
            if "bytes_limit" in stats:
                info["hbm_bytes"] = stats["bytes_limit"]
            if "bytes_in_use" in stats:
                info["hbm_in_use"] = stats["bytes_in_use"]
        except Exception:
            pass
        infos.append(info)
    return infos


def print_device_info() -> None:
    print("== Device Properties ==")
    print(f"backend: {jax.default_backend()}")
    print(f"device count: {jax.device_count()} "
          f"(local: {jax.local_device_count()})")
    for info in device_info():
        parts = [f"[{info['id']}] {info['device_kind']} ({info['platform']})"]
        if "hbm_bytes" in info:
            parts.append(f"memory {info['hbm_bytes'] / 2**30:.1f} GiB")
        print("  " + "  ".join(parts))
