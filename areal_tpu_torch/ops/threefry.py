"""Threefry-2x32 random numbers bit for bit as `jax.random` draws them,
and the sampler's position-keyed Gumbel noise as one kernel on the card.

The plain functions are `jax.random`'s arithmetic (jax's default
`jax_threefry_partitionable=True`) on int64 tensors holding uint32 values,
masked to 32 bits after every add and shift:

- `threefry2x32(k0, k1, x0, x1)`: the 20-round Threefry-2x32 hash
  (`jax._src.prng._threefry2x32_lowering`, unrolled);
- `fold_in(key, d)` = `threefry2x32(key, (0, d))`;
- `random_bits(key, n)[i]` = `y0 ^ y1` of `threefry2x32(key, (0, i))`;
- `uniform(key, n)`: the mantissa trick of `jax._src.random._uniform` with
  minval = the smallest normal f32 and maxval = 1;
- `gumbel(key, n)` = `-log(-log(uniform))` (`_gumbel`, mode "low").

Keys are `[R, 2]` int64 tensors of uint32 values (one per row), as
`jax.vmap` over `[R, 2]` uint32 keys would take them; `n` is the length
of each row's draw. Bits and uniforms equal JAX's exactly; Gumbel values
within `GUMBEL_TOL`, since `log` may differ in its last ulp between XLA
and PyTorch or CUDA.

`gumbel_noise(base_keys, positions, n)` is what the sampler draws per
step: row r's noise under `fold_in(base_keys[r], positions[r])` (and
`fold_in(.., 1)` of that with `secondary`, the top-p draw). On a CUDA
tensor it launches the kernel (`csrc/threefry.cu`), one launch for the
whole `[R, n]` block where the plain version is ~150 elementwise ops; on
a CPU tensor it runs the plain version. `launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from areal_tpu_torch.ops import _build

M32 = 0xFFFFFFFF
TINY = torch.finfo(torch.float32).tiny
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# |g - ref| <= atol + rtol * |ref| between Gumbel values from two `log`
# implementations: each log is within 1 ulp (2^-23 relative), which the
# outer log turns into an absolute error of ~1e-7
GUMBEL_TOL = (1e-6, 1e-6)
KINDS = ("gumbel", "uniform", "bits")

# kernel launches since the process started (or the last reset to 0)
launches = 0

_lib: ctypes.CDLL | None = None


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the count pair (x0, x1) under key (k0, k1); all
    int64 tensors (or ints) of uint32 values, broadcast together."""
    k0, k1, x0, x1 = (torch.as_tensor(t, dtype=torch.int64) for t in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in` per row: key `[..., 2]`, data (int or int
    tensor broadcasting against `key[..., 0]`) -> `[..., 2]`."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,), uint32)` per row: key `[R, 2]` ->
    `[R, n]` int64 of uint32 values."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[:, :1], key[:, 1:], torch.zeros_like(i), i)
    return y0 ^ y1


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # floats * (maxval - minval) + minval, with maxval - minval == 1 in f32
    return torch.clamp_min(f + TINY, TINY)


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.uniform(key, (n,), minval=tiny, maxval=1)` per row:
    key `[R, 2]` -> f32 `[R, n]`."""
    return _bits_to_uniform(random_bits(key, n))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.gumbel(key, (n,))` per row (mode "low"): key `[R, 2]`
    -> f32 `[R, n]`."""
    return -torch.log(-torch.log(uniform(key, n)))


def _subkeys(base_keys: torch.Tensor, positions: torch.Tensor, secondary: bool) -> torch.Tensor:
    key = fold_in(base_keys, positions)
    return fold_in(key, 1) if secondary else key


def gumbel_noise_ref(base_keys, positions, n: int, *, secondary: bool = False,
                     kind: str = "gumbel") -> torch.Tensor:
    """Plain version of `gumbel_noise`."""
    key = _subkeys(base_keys, positions, secondary)
    if kind == "bits":
        return random_bits(key, n)
    if kind == "uniform":
        return uniform(key, n)
    return gumbel(key, n)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("threefry")
        lib.areal_threefry_noise.argtypes = [
            ctypes.c_void_p,  # base keys [R, 2] int64
            ctypes.c_void_p,  # positions [R] int64
            ctypes.c_void_p,  # out [R, n]
            ctypes.c_int,  # R
            ctypes.c_int,  # n
            ctypes.c_int,  # secondary
            ctypes.c_int,  # kind: 0 gumbel, 1 uniform, 2 bits
            ctypes.c_void_p,  # stream
        ]
        lib.areal_threefry_noise.restype = ctypes.c_int
        lib.areal_threefry_error_string.argtypes = [ctypes.c_int]
        lib.areal_threefry_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def gumbel_noise(base_keys: torch.Tensor, positions: torch.Tensor, n: int, *,
                 secondary: bool = False, kind: str = "gumbel") -> torch.Tensor:
    """Row r's draw under `fold_in(base_keys[r], positions[r])` (then
    `fold_in(.., 1)` with `secondary`): f32 `[R, n]` Gumbel noise, or its
    uniforms, or its raw bits (int64 of uint32 values) by `kind`.
    base_keys `[R, 2]` int64 of uint32 values, positions `[R]` int64."""
    global launches
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r} not in {KINDS}")
    if base_keys.device.type == "cpu":
        return gumbel_noise_ref(base_keys, positions, n, secondary=secondary, kind=kind)
    if base_keys.device.type != "cuda":
        raise ValueError(f"gumbel_noise runs on cuda or cpu, not {base_keys.device}")
    R = base_keys.shape[0]
    for name, t, shape in (("base_keys", base_keys, (R, 2)), ("positions", positions, (R,))):
        if t.dtype != torch.int64 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int64 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != base_keys.device:
            raise ValueError(f"{name} is on {t.device}, base_keys on {base_keys.device}")
    if not 0 < n < 2**31 or R >= 65536:
        raise ValueError(f"n={n}, R={R}: need 0 < n < 2^31 and R < 65536")
    out = torch.empty((R, n), dtype=torch.int32 if kind == "bits" else torch.float32,
                      device=base_keys.device)
    if R == 0:
        return out.long() if kind == "bits" else out
    lib = _kernel_lib()
    err = lib.areal_threefry_noise(
        base_keys.data_ptr(), positions.data_ptr(), out.data_ptr(), R, n,
        int(secondary), KINDS.index(kind),
        torch.cuda.current_stream(base_keys.device).cuda_stream,
    )
    if err != 0:
        msg = lib.areal_threefry_error_string(err).decode()
        raise RuntimeError(f"threefry noise kernel launch failed: {msg} ({err})")
    launches += 1
    return out.long() & M32 if kind == "bits" else out
