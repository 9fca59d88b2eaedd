"""The port's FD3D step (``repro_torch.kernels.fd3d``) against the JAX
reference, on the same numpy inputs.

On the CPU the port runs its plain PyTorch version; the CUDA kernel itself is
held against that version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  Tolerances are the reference's own
(``tests/test_kernels_fd3d.py``): 2e-5 in float32, 0.15 in bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fd3d import ref as jref
from repro.kernels.fd3d.fd3d import fd3d_pallas
from repro_torch.kernels.fd3d import fd3d as tkernel
from repro_torch.kernels.fd3d import fd3d_step, ref as tref

SWEEP = [(8, 16, 16), (16, 16, 16), (16, 24, 16), (32, 16, 32), (8, 8, 8)]
RAGGED = [(13, 17, 29), (1, 9, 130), (1, 1, 1), (5, 1, 3)]
TOL = {"float32": 2e-5, "bfloat16": 0.15}


def _fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(np.float32)
    up = rng.standard_normal(shape).astype(np.float32)
    c2 = np.full(shape, 0.1, np.float32)
    return u, up, c2


def _jax(a, dtype):
    return jnp.asarray(a, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def test_constants_match_reference():
    assert tref.C0 == jref.C0
    assert tref.COEF == jref.COEF
    assert tref.HALO == jref.HALO


@pytest.mark.parametrize("shape", SWEEP + RAGGED)
def test_laplacian_matches_jax(shape):
    u, _, _ = _fields(shape)
    got = tref.laplacian(torch.from_numpy(u), 10.0).numpy()
    want = np.asarray(jref.laplacian(jnp.asarray(u), 10.0))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SWEEP + RAGGED)
def test_fd3d_step_matches_jax(shape, dtype):
    u, up, c2 = _fields(shape, seed=len(shape) + sum(shape))
    got = tref.fd3d_step(_torch(u, dtype), _torch(up, dtype), _torch(c2, dtype), 5.0)
    want = jref.fd3d_step(_jax(u, dtype), _jax(up, dtype), _jax(c2, dtype), 5.0)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("shape,bz", [((8, 16, 16), 8), ((16, 24, 16), 4)])
def test_ref_matches_pallas_interpret(shape, bz):
    u, up, c2 = _fields(shape, seed=3)
    got = tref.fd3d_step(*(torch.from_numpy(a) for a in (u, up, c2)), 10.0).numpy()
    want = fd3d_pallas(*(jnp.asarray(a) for a in (u, up, c2)), dx=10.0, bz=bz,
                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_laplacian_of_quadratic_is_constant():
    """lap(x^2 + y^2 + z^2) == 6 exactly for an 8th-order stencil."""
    n = 24
    ax = torch.arange(n, dtype=torch.float32)
    x, y, z = torch.meshgrid(ax, ax, ax, indexing="ij")
    lap = tref.laplacian(x * x + y * y + z * z, dx=1.0)
    h = tref.HALO + 1
    np.testing.assert_allclose(lap[h:-h, h:-h, h:-h].numpy(), 6.0, rtol=1e-3, atol=1e-3)


def test_ops_cpu_tensor_takes_ref_without_launch():
    u, up, c2 = (torch.from_numpy(a) for a in _fields((8, 16, 16)))
    before = tkernel.launches
    got = fd3d_step(u, up, c2, dx=10.0)
    assert tkernel.launches == before
    torch.testing.assert_close(got, tref.fd3d_step(u, up, c2, 10.0), rtol=0, atol=0)
    torch.testing.assert_close(
        fd3d_step(u, up, c2, dx=10.0, backend="ref"), got, rtol=0, atol=0
    )


@pytest.mark.parametrize("backend", ["pallas", "cuda", "triton", ""])
def test_ops_unknown_backend_raises(backend):
    u, up, c2 = (torch.from_numpy(a) for a in _fields((8, 8, 8)))
    with pytest.raises(ValueError, match="unknown backend"):
        fd3d_step(u, up, c2, dx=1.0, backend=backend)


def _bad_inputs():
    u, up, c2 = (torch.from_numpy(a) for a in _fields((8, 8, 8)))
    return {
        "rank": (u[0], up[0], c2[0]),
        "empty axis": (u[:0], up[:0], c2[:0]),
        "shape": (u, up[:4], c2),
        "dtype": (u, up.double(), c2),
        "unsupported dtype": (u.half(), up.half(), c2.half()),
        "non-contiguous": (u.transpose(0, 2), up, c2),
        "cpu device": (u, up, c2),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_kernel_wrapper_rejects_bad_inputs_before_launch(case):
    """The wrapper checks shape, dtype, contiguity and device and raises:
    a CPU tensor never reaches the build or a launch, and is never served
    by the plain version behind the caller's back."""
    before = tkernel.launches
    with pytest.raises(ValueError):
        tkernel.fd3d_cuda(*_bad_inputs()[case], dx=1.0)
    assert tkernel.launches == before


def _bad_epilogues():
    u, up, c2 = (torch.from_numpy(a) for a in _fields((4, 5, 6)))
    ramps = tuple(torch.ones(n) for n in (4, 5, 6))
    amp = torch.tensor([0.5])[0]
    ok = {"taper": ramps, "src": (1, 2, 3), "amp": amp}
    cases = {
        "taper alone": {"taper": ramps},
        "no amp": {"taper": ramps, "src": (1, 2, 3)},
        "two ramps": {**ok, "taper": ramps[:2]},
        "ramp length": {**ok, "taper": (ramps[0], ramps[1], torch.ones(5))},
        "ramp rank": {**ok, "taper": (ramps[0].view(4, 1), ramps[1], ramps[2])},
        "ramp dtype": {**ok, "taper": (ramps[0].double(), ramps[1], ramps[2])},
        "ramp device": {**ok, "taper": (torch.ones(4, device="meta"), ramps[1], ramps[2])},
        "source outside": {**ok, "src": (4, 0, 0)},
        "negative source": {**ok, "src": (0, -1, 0)},
        "amp dtype": {**ok, "amp": amp.double()},
        "amp size": {**ok, "amp": torch.ones(2)},
    }
    return (u, up, c2), cases


@pytest.mark.parametrize("case", list(_bad_epilogues()[1]))
def test_kernel_wrapper_rejects_bad_epilogue_before_launch(case):
    """The epilogue's operands are checked before the device: a wrong ramp,
    source or amplitude raises on the CPU too, and nothing launches."""
    fields, cases = _bad_epilogues()
    before = tkernel.launches, tkernel.epilogue_launches
    with pytest.raises(ValueError):
        tkernel.fd3d_cuda(*fields, dx=1.0, **cases[case])
    assert (tkernel.launches, tkernel.epilogue_launches) == before


@pytest.mark.parametrize("backend", [None, "ref"])
@pytest.mark.parametrize("case", list(_bad_epilogues()[1]))
def test_ops_plain_path_rejects_bad_epilogue(case, backend):
    """The plain path takes the epilogue's operands under the kernel's
    rules: what the kernel refuses, the CPU refuses too."""
    fields, cases = _bad_epilogues()
    with pytest.raises(ValueError):
        fd3d_step(*fields, dx=1.0, backend=backend, **cases[case])
