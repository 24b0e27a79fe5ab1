"""JAX set-up, the device policy, and the 3-D FFT helpers.

setup() selects the platform and turns on JAX's persistent compilation
cache.  transfer_policy() is the one place where the platform JAX runs on
decides how the fmax products reach the host: it knows "gpu" and "cpu"
and refuses any other platform.  rfft3/irfft3 are the 3-D transforms
every engine uses (cuFFT on the GPU).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DONE = False


def cache_dir(environ=None) -> str:
    """Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set,
    else a fixed .jax_cache/ at the repository root (the path is part of
    the cache key, so it must not move between runs)."""
    environ = os.environ if environ is None else environ
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".jax_cache"))


def setup(platform: str | None = None) -> None:
    global _DONE
    if platform:
        jax.config.update("jax_platforms", platform)
    if not _DONE:
        jax.config.update("jax_compilation_cache_dir", cache_dir())
        _DONE = True


def transfer_policy(params, platform: str | None = None):
    """(sparse, f16) switches of the device->host product transfer.

    sparse: compact the needed particles (Fmax >= Flast) on the device
    and sort them in sweep order before the transfer.  On by default on
    the GPU, where it also spares the host a full-grid sort; off on the
    CPU, where device and host share memory.
    f16: float16 displacement rows on the wire.  Off by default on both
    platforms (an explicit params.transfer_f16 still turns it on).
    params.sparse_transfer / params.transfer_f16 override the defaults."""
    platform = platform or jax.default_backend()
    if platform not in ("gpu", "cpu"):
        raise RuntimeError(f"no device policy for platform {platform!r} "
                           "(supported: gpu, cpu)")
    sparse = params.sparse_transfer
    if sparse is None:
        sparse = platform == "gpu"
    f16 = params.transfer_f16
    if f16 is None:
        f16 = False
    return bool(sparse), bool(f16)


def rfft3(x):
    """3-D r2c transform, layout [N, N, N] -> [N, N, N//2+1]."""
    return jnp.fft.fft2(jnp.fft.rfft(x, axis=2), axes=(0, 1))


def irfft_z(u, n: int):
    """c2r along the last axis, taking the kz = 0 and kz = n/2 planes as
    real: the real part of the inverse DFT of a half spectrum that need
    not be Hermitian there.  c2r libraries differ on what they make of
    imaginary parts in those planes (pocketfft drops them, cuFFT does
    not), and they are not zero after the x/y transform of a field whose
    Nyquist modes are set (the LPT sources are products of fields), or
    after an odd derivative, whose Nyquist k has one sign."""
    for kz in ((0, n // 2) if n % 2 == 0 else (0,)):
        u = u.at[..., kz].set(jnp.real(u[..., kz]).astype(u.dtype))
    return jnp.fft.irfft(u, n=n, axis=-1)


def irfft3(k, n: int):
    """3-D c2r transform, layout [N, N, N//2+1] -> [N, N, N]."""
    return irfft_z(jnp.fft.ifft2(k, axes=(0, 1)), n)
