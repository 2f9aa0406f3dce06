"""A numpy copy of ``jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)``
for float32 and float64, so that the port draws what the JAX package draws
without importing JAX.

The JAX package draws aGRAAL's companion point as ``x + normal(PRNGKey(0),
x.shape)`` (``adaprox_tpu/solvers/agraal.py`` and the drivers). The copy has
four parts, each as JAX's default PRNG implementation ``threefry2x32`` with
``jax_threefry_partitionable`` on:

  * the key: ``PRNGKey(seed)`` is the pair [seed >> 32, seed & 0xffffffff];
  * the counters: the flat index of each element as a 64-bit integer, split
    into its high and low words;
  * the bits: threefry2x32 (five groups of four rounds, rotations
    (13, 15, 26, 6) / (17, 29, 16, 24), the key schedule with 0x1BD11BDA) of
    each counter pair, then b1 ^ b2 (32 bits) or (b1 << 32) | b2 (64 bits);
  * the normal: the mantissa trick to a uniform on [nextafter(-1, 0), 1), then
    sqrt(2) erf_inv(u) with the polynomials XLA lowers ``erf_inv`` to
    (M. Giles, "Approximating the erfinv function": two branches in float32,
    three in float64), on XLA's own log1p.

The uniform bits are JAX's exactly. The normal differs by a few ulps where
XLA's compiled arithmetic rounds otherwise than numpy's
(tests/test_torch_agraal.py states the measured bound).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["prng_key", "random_bits", "uniform", "normal"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's erf_inv polynomials (Giles), highest degree first: float32 for
# w = -log1p(-x^2) < 5 and >= 5
_ERFINV_F32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
# float64: w < 6.25, w < 16 and w >= 16
_ERFINV_F64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
     1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
     2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
     4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
     0.24015818242558961693, 1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
     1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
     6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
     -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
     -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
     -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
     1.0103004648645343977, 4.8499064014085844221),
)
# XLA's log1p: x - x^2/2 + x^3 P(x)/Q(x) (Cephes) for |x| < sqrt(2) - 1, else log(1 + x)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969,
            2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2, 2.1642788614495947685003e2,
            6.0118660497603843919306e1)


def prng_key(seed):
    """``jax.random.PRNGKey(seed)`` for an integer seed in [0, 2**64): the
    uint32 pair [seed >> 32, seed & 0xffffffff]."""
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be an integer in [0, 2**64), got {seed}")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def _threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0 + ks[0], x1 + ks[1]]
    for group in range(5):
        for rot in _ROTATIONS[group % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(rot)) | (x[1] >> np.uint32(32 - rot))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(group + 1) % 3]
        x[1] = x[1] + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x


def random_bits(seed, bit_width, shape):
    """``jax.random.bits``' raw bits of 32 or 64 bits for ``shape`` under
    ``PRNGKey(seed)``, in the partitionable layout: one hash a flat index."""
    if bit_width not in (32, 64):
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    size = math.prod(shape)
    counts = np.arange(size, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = _threefry2x32(prng_key(seed), hi, lo)
    if bit_width == 32:
        bits = b1 ^ b2
    else:
        bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    return bits.reshape(shape)


def _float_dtype(dtype):
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise TypeError(f"the copy of JAX's draw covers float32 and float64, not {dtype}")
    return dtype


def uniform(seed, shape, dtype=np.float32, minval=0.0, maxval=1.0):
    """``jax.random.uniform(PRNGKey(seed), shape, dtype, minval, maxval)``:
    random mantissa bits under the exponent of 1.0, minus 1, scaled to
    [minval, maxval) and clamped below at minval, in ``dtype``."""
    dtype = _float_dtype(dtype)
    finfo = np.finfo(dtype)
    nbits = finfo.bits
    uint = np.uint32 if nbits == 32 else np.uint64
    bits = random_bits(seed, nbits, tuple(shape))
    float_bits = (bits >> uint(nbits - finfo.nmant)) | np.array(1.0, dtype).view(uint)
    floats = float_bits.view(dtype) - dtype.type(1.0)
    lo, hi = dtype.type(minval), dtype.type(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _horner(x, coefs):
    p = np.zeros_like(x)
    for c in coefs:
        p = p * x + x.dtype.type(c)
    return p


def _log1p(x):
    """XLA's log1p, operation by operation (numpy's own differs by up to 128
    ulps near |x| = sqrt(2) - 1, where XLA's rational form is least exact)."""
    dt = x.dtype.type
    x2 = x * x
    small = x + (dt(-0.5) * x2 + (x * x2) * (_horner(x, _LOG1P_P) / _horner(x, _LOG1P_Q)))
    return np.where(np.abs(x) < dt(0.41421356237309504880), small, np.log(dt(1.0) + x))


def _erf_inv(x):
    """XLA's erf_inv (float32 or float64 ``x``), operation by operation."""
    dt = x.dtype.type
    w = -_log1p(x * -x)
    if x.dtype == np.float32:
        lt = w < dt(5.0)
        w = np.where(lt, w - dt(2.5), np.sqrt(w) - dt(3.0))
        small, large = (np.asarray(c, np.float32) for c in _ERFINV_F32)
        p = np.where(lt, small[0], large[0])
        for i in range(1, 9):
            p = np.where(lt, small[i], large[i]) + p * w
    else:
        lt625, lt16 = w < dt(6.25), w < dt(16.0)
        c625, c16, cbig = _ERFINV_F64
        w = np.where(lt625, w - dt(3.125),
                     np.sqrt(w) - np.where(lt16, dt(3.25), dt(5.0)))

        def coef(i):
            c = np.full_like(x, c625[i])
            if i < 19:
                c = np.where(lt625, c, dt(c16[i]))
            if i < 17:
                c = np.where(lt16, c, dt(cbig[i]))
            return c

        p = coef(0)
        for i in range(1, 17):
            p = coef(i) + p * w
        for i in range(17, 19):
            p = np.where(lt16, coef(i) + p * w, p)
        for i in range(19, 23):
            p = np.where(lt625, coef(i) + p * w, p)
    return np.where(np.abs(x) == dt(1.0), x * dt(np.inf), p * x)


def normal(seed, shape, dtype=np.float32):
    """``jax.random.normal(PRNGKey(seed), shape, dtype)``: sqrt(2) erf_inv(u)
    of u uniform on [nextafter(-1, 0), 1), as a numpy array of ``dtype``."""
    dtype = _float_dtype(dtype)
    lo = np.nextafter(np.array(-1.0, dtype), np.array(0.0, dtype), dtype=dtype)
    u = uniform(seed, shape, dtype, lo, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return (np.array(np.sqrt(2), dtype) * _erf_inv(u)).astype(dtype)
