"""The port's fp8 cast and its fp8 oracle against the JAX package's, on the CPU.

On CPU tensors the port's ``kernels/fp8_cast/ops.fp8_cast_tensorwise``
runs its plain version (``ref.py``), which repeats the Pallas kernel's
arithmetic: the reciprocal of ``max(absmax, 1e-12)`` first, then the
product. It is held against the JAX package's Pallas kernel in interpret
mode (``backend="pallas_interpret"``) on the same inputs, made from a
seeded numpy generator:

* bit for bit (f32 bits, so the sign of a zero counts), both formats, at
  17, 257, 512 and 1,030 rows x 130 (the last ragged against the kernel's
  512-row blocks), f32 and bf16 inputs, with the tensor's own absmax, a
  larger stale one and one small enough that values clip at the format's
  max; the inputs hold exact fp8 ties after scaling, values in the fp8
  subnormal range and zeros of both signs; and an all-zero tensor with
  absmax 0;
* at the two inputs where the JAX package's Pallas kernel and its XLA
  path (which divides x / absmax) round to different fp8 neighbours: the
  port gives the Pallas kernel's value, and the XLA path's differs;
* against the JAX package's ``ref`` (a division too) within that package's
  own tolerance (``tests/test_kernels.py``): fewer than 5e-3 of the
  elements differ, each by at most one ``fp8_quantization_step``.

The port's ``core/fp8.py`` (the frexp/ldexp oracle) against the JAX
package's: ``fp8_values`` equal, ``fp8_round`` and
``fp8_quantization_step`` bit for bit over the whole grid, its ties, one
f32 ulp either side of each and a million random values; and the port's
``fp8_grid_round`` (the bit trick the kernels share) against that oracle.

The build: ``kernels/csrc/fp8_grid.cuh`` is the one definition of
``grid_round``, included by both fp8 sources, and an edit of it renames
both libraries (``kernels/build.library_path`` hashes every local header
a source includes), so no stale library is loaded after it.

The CUDA kernel runs only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` (phase 27) hold it against the plain version there.
"""
from __future__ import annotations

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fp8 as JF8
from repro.kernels.fp8_cast import ops as JFC
from repro_torch.core import fp8 as F8
from repro_torch.core import quantization as Q
from repro_torch.kernels import build as KB
from repro_torch.kernels.fp8_cast import ops as FC

torch.set_num_threads(1)

FMTS = ("e4m3", "e5m2")
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# the inputs of the Pallas kernel's and the XLA path's disagreement:
# (fmt, absmax, x, the Pallas kernel's value, the XLA path's value)
SPLIT_CASES = [("e4m3", 3.0, 0.0556640587747097, 0.01953125, 0.017578125),
               ("e5m2", 7.0, 0.00037384030292741954, 6.103515625e-05, 4.57763671875e-05)]


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a.astype(np.float32)).view(np.int32)


def _grid(fmt) -> np.ndarray:
    """Every finite value of the format, both signs, ascending."""
    v = JF8.fp8_values(JF8.SPECS[fmt])
    return np.unique(np.concatenate([-v, v])).astype(np.float32)


def _cast_input(rng, R, fmt, dt):
    """(x (R, 130) as numpy f32 holding values of the input dtype, its own
    absmax): rows over eight binades below 64, then row 0 puts 64 in front
    (absmax 64, so 1/absmax = 2^-6 is exact), row 1 the fp8 ties in [-1, 1]
    times 64 (exact ties after scaling), row 2 fp8-subnormal values and
    ties there, row 3 zeros of both signs."""
    x = rng.standard_normal((R, 130)) * np.exp(rng.uniform(-4, 0.5, (R, 1)))
    x = np.clip(x, -63, 63).astype(np.float32)
    g = _grid(fmt)
    unit = g[np.abs(g) <= 1.0].astype(np.float64)
    ties = ((unit[:-1] + unit[1:]) / 2 * 64).astype(np.float32)
    sub = ties[np.abs(ties) < 64 * 2.0 ** (1 - JF8.SPECS[fmt].bias)]
    x[0, 0] = 64.0
    x[1] = np.resize(ties[::-1], 130)
    x[2] = np.resize(sub, 130)
    x[3] = np.where(np.arange(130) % 2 == 0, 0.0, -0.0).astype(np.float32)
    if dt == "bf16":             # round to bf16 values (ties and subnormals are already)
        x = torch.from_numpy(x).bfloat16().float().numpy()
    x[0, 0] = 64.0
    return x, np.float32(np.abs(x).max())


def _both(x, absmax, fmt, dt, backend="pallas_interpret"):
    """(the port's output, the JAX package's) on the same input."""
    tdt, jdt = DTYPES[dt]
    port = FC.fp8_cast_tensorwise(torch.from_numpy(x).to(tdt), torch.tensor(absmax), fmt)
    jax_out = JFC.fp8_cast_tensorwise(jnp.asarray(x, jdt), jnp.float32(absmax), fmt=fmt,
                                      backend=backend)
    return port, np.asarray(jax_out)


@pytest.mark.parametrize("scale", ["tensor", "stale", "clips"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("rows", [17, 257, 512, 1030])
@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_cast_matches_the_pallas_kernel_bitwise(fmt, rows, dt, scale):
    rng = np.random.default_rng(rows * 7 + len(fmt) + len(dt) + len(scale))
    x, amax = _cast_input(rng, rows, fmt, dt)
    absmax = {"tensor": amax, "stale": np.float32(amax * 3.7),
              "clips": np.float32(amax * 2.0 ** -17)}[scale]
    port, want = _both(x, absmax, fmt, dt)
    assert port.dtype == torch.float32 and tuple(port.shape) == (rows, 130)
    np.testing.assert_array_equal(_bits(port), _bits(want))
    fmax = Q.FP8_MAX[fmt]
    if scale == "clips":
        assert float(port.abs().max()) == fmax
    if scale == "tensor":        # absmax 64: row 1's ties round half to even
        ties = torch.from_numpy(x[1]) / 64
        np.testing.assert_array_equal(_bits(port[1]), _bits(F8.fp8_round(ties, F8.SPECS[fmt])))


@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_cast_of_an_all_zero_tensor(fmt):
    x = np.zeros((33, 130), np.float32)
    port, want = _both(x, np.float32(0.0), fmt, "f32")
    np.testing.assert_array_equal(_bits(port), _bits(want))
    assert not bool(port.any())


@pytest.mark.parametrize("fmt,absmax,xv,pallas,xla", SPLIT_CASES)
def test_fp8_cast_follows_the_kernel_where_the_xla_path_differs(fmt, absmax, xv, pallas, xla):
    """The JAX kernel multiplies by the reciprocal, its XLA path divides; on
    these inputs the two f32 values straddle an fp8 tie. The port is the
    kernel's function."""
    x = np.full((4, 130), xv, np.float32)
    port, kernel = _both(x, np.float32(absmax), fmt, "f32")
    _, by_xla = _both(x, np.float32(absmax), fmt, "f32", backend="xla")
    np.testing.assert_array_equal(_bits(port), _bits(kernel))
    assert (port.numpy() == np.float32(pallas)).all()
    assert (by_xla == np.float32(xla)).all() and xla != pallas


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("rows", [17, 257, 512])
def test_fp8_cast_against_the_jax_ref_within_its_tolerance(fmt, rows):
    """JAX's own tolerance between its kernel and its ``ref``: the division
    of ``ref`` moves rare ties by at most one quantization step."""
    rng = np.random.default_rng(rows + len(fmt))
    x = (rng.standard_normal((rows, 130)) * 5).astype(np.float32)
    amax = np.float32(np.abs(x).max())
    port, ref = _both(x, amax, fmt, "f32", backend="ref")
    a = port.numpy()
    assert np.mean(a != ref) < 5e-3
    step = np.asarray(JF8.fp8_quantization_step(jnp.asarray(a), JF8.SPECS[fmt]))
    assert np.all(np.abs(a - ref) <= step + 1e-12)


def test_fp8_cast_wrapper_checks_and_counts_no_cpu_launch():
    FC.reset_launch_counts()
    x = torch.randn(4, 8)
    with pytest.raises(TypeError):
        FC.fp8_cast_tensorwise(x, torch.tensor(1.0, dtype=torch.float64))
    with pytest.raises(TypeError):
        FC.fp8_cast_tensorwise(x, torch.ones(2))
    with pytest.raises(ValueError):
        FC.fp8_cast_tensorwise(x, torch.tensor(1.0), "e3m4")
    with pytest.raises(ValueError):
        FC.fp8_cast_tensorwise(x.t(), torch.tensor(1.0))        # not contiguous
    with pytest.raises(TypeError):
        FC.fp8_cast_tensorwise(x.double(), torch.tensor(1.0))
    out = FC.fp8_cast_tensorwise(x, torch.ones(1, 1), "e5m2")
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert FC.launch_counts() == {"fp8_cast_tensorwise": 0}


# ---------------------------------------------------------------------------
# core/fp8.py, the frexp/ldexp oracle
# ---------------------------------------------------------------------------

def _sweep(fmt) -> np.ndarray:
    """The grid, its ties, one f32 ulp either side of each, values past the
    max, zeros of both signs and 10^6 random values over many binades."""
    g = _grid(fmt)
    mids = ((g[:-1].astype(np.float64) + g[1:]) / 2).astype(np.float32)
    exact = np.concatenate([g, mids])
    fmax = JF8.SPECS[fmt].max_value
    rng = np.random.default_rng(len(fmt))
    rand = (rng.standard_normal(10 ** 6) * np.exp2(rng.uniform(-22, 18, 10 ** 6)))
    return np.concatenate([exact, np.nextafter(exact, np.float32(np.inf)),
                           np.nextafter(exact, np.float32(-np.inf)),
                           np.array([fmax * 1.01, -fmax * 1.5, 1e30, -1e30, 1e-40, 0.0, -0.0]),
                           rand]).astype(np.float32)


@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_values_are_the_jax_packages(fmt):
    want = JF8.fp8_values(JF8.SPECS[fmt])
    got = F8.fp8_values(F8.SPECS[fmt])
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert F8.SPECS[fmt] == F8.FP8Spec(*[getattr(JF8.SPECS[fmt], f) for f in (
        "name", "exp_bits", "man_bits", "bias", "max_value")])


@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_round_and_step_match_jax_bitwise(fmt):
    v = _sweep(fmt)
    got = F8.fp8_round(torch.from_numpy(v), F8.SPECS[fmt])
    want = JF8.fp8_round(jnp.asarray(v), JF8.SPECS[fmt])
    np.testing.assert_array_equal(_bits(got), _bits(want))
    got = F8.fp8_quantization_step(torch.from_numpy(v), F8.SPECS[fmt])
    want = JF8.fp8_quantization_step(jnp.asarray(v), JF8.SPECS[fmt])
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_grid_round_matches_the_oracle(fmt):
    """The bit trick that the plain versions and the kernels share equals
    the frexp/ldexp oracle on every value of the sweep, ties included."""
    v = torch.from_numpy(_sweep(fmt))
    got = Q.fp8_grid_round(v, fmt)
    want = F8.fp8_round(v, F8.SPECS[fmt])
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isin(got.numpy(), _grid(fmt)).all()


# ---------------------------------------------------------------------------
# the build: one grid_round, and a library named by its headers too
# ---------------------------------------------------------------------------

KERNELS_DIR = Path(KB.__file__).resolve().parent
FP8_SOURCES = ("fp8_matmul/csrc/fp8_matmul.cu", "fp8_cast/csrc/fp8_cast.cu")
HEADER = "csrc/fp8_grid.cuh"


def test_grid_round_has_one_definition_shared_by_both_fp8_sources():
    defined = [p.relative_to(KERNELS_DIR).as_posix() for p in KERNELS_DIR.rglob("*.cu*")
               if "float grid_round(" in p.read_text()]
    assert defined == [HEADER]
    for src in FP8_SOURCES:
        assert (KERNELS_DIR / HEADER).resolve() in KB.source_files(KERNELS_DIR / src)


def test_editing_a_header_renames_the_libraries_that_include_it(tmp_path):
    """In a copy of the kernel sources and the shared headers: an edit of
    the shared fp8 header changes the library name of both sources that
    include it; an edit of one source changes its own name only."""
    headers = [p.relative_to(KERNELS_DIR).as_posix()
               for p in (KERNELS_DIR / "csrc").glob("*.cuh")]
    for rel in (*FP8_SOURCES, *headers, "switchback/csrc/switchback.cu"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(KERNELS_DIR / rel, tmp_path / rel)
    names = lambda: {rel: KB.library_path(tmp_path / rel).name
                     for rel in (*FP8_SOURCES, "switchback/csrc/switchback.cu")}
    before = names()
    assert before == {rel: KB.library_path(KERNELS_DIR / rel).name for rel in before}
    with open(tmp_path / HEADER, "a") as f:
        f.write("// an edit\n")
    after = names()
    assert all(after[rel] != before[rel] for rel in FP8_SOURCES)
    assert after["switchback/csrc/switchback.cu"] == before["switchback/csrc/switchback.cu"]
    with open(tmp_path / FP8_SOURCES[1], "a") as f:
        f.write("// an edit\n")
    last = names()
    assert last[FP8_SOURCES[1]] != after[FP8_SOURCES[1]]
    assert last[FP8_SOURCES[0]] == after[FP8_SOURCES[0]]
