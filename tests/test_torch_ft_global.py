"""Kernels B4 (``global``, encode vpu) and B8 (``global``, encode mxu): the
port against the JAX package, on the same numpy inputs and injection.

The JAX side runs ``ft_sgemm_tpu.make_ft_sgemm(..., strategy="global",
encode=...)`` in interpret mode; the port runs its plain versions
(``device="cpu"``). At the JAX package's tiles the per-tile event counts
must be EQUAL, ``uncorrectable`` must equal ``detections`` (detect only),
and, since both sides leave the same faults in C, the port's C must pass
``verify_matrix`` against the JAX package's C everywhere; clean runs must
also pass against the oracle. The card test (marker ``cuda``) holds the
CUDA kernels against their plain versions.
"""

import numpy as np
import pytest
import torch
from test_torch_ft_sgemm import CASES, TILES, _inputs, _run_both, cuda_device  # noqa: F401

from ft_sgemm_tpu_torch import SHAPES
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops.common import pad_to, scalar_operand
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("encode", ["vpu", "mxu"])
@pytest.mark.parametrize("case,dims,inj_kw,check_every", CASES,
                         ids=[c[0] for c in CASES])
def test_global_matches_jax(tile, encode, case, dims, inj_kw, check_every):
    jres, res, want, _ = _run_both(tile, "global", dims, inj_kw, check_every,
                                   encode=encode)
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)
    np.testing.assert_array_equal(res.detections.numpy(), jdet)
    np.testing.assert_array_equal(res.uncorrectable.numpy(), junc)
    np.testing.assert_array_equal(junc, jdet)
    got = res.c.numpy()
    assert got.shape == want.shape
    # Both packages keep the same faults in C: compare C everywhere.
    ok, nbad, first = verify_matrix(np.asarray(jres.c), got, verbose=False)
    assert ok, f"{nbad} elements off the JAX package's C, first at {first}"
    if case == "clean":
        assert jdet.sum() == 0
        ok, nbad, first = verify_matrix(want, got, verbose=False)
        assert ok, f"{nbad} elements off the oracle, first at {first}"
    else:
        assert (jdet > 0).all()  # every tile took faults and saw them


def test_global_counts_events_not_faults():
    # Four faults per tile, one check: one event per tile. The clamp of the
    # correcting strategies would have cut the cadence to bn * every = 128
    # steps; global keeps the explicit 4.
    jres, res, _, _ = _run_both("t128", "global", (256, 256, 512),
                                dict(enabled=True, every=1), 4)
    assert (res.detections.numpy() == 1).all()
    assert (np.asarray(jres.detections) == 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kind", ["global", "global_mxu"])
def test_global_kernels_match_plain_on_card(cuda_device, name, kind):
    shape = SHAPES[name]
    a, b, c = (pad_to(torch.from_numpy(x).to(cuda_device), *mult)
               for x, mult in zip(_inputs(250, 250, 256, seed=8),
                                  ((shape.bm, shape.bk), (shape.bn, shape.bk),
                                   (shape.bm, shape.bn))))
    sc = scalar_operand(InjectionSpec(enabled=True, every=2), (9500.0,) * 3)
    extra = ft.kernel_inputs(kind, a, b, shape)
    got = ft.run_kernel(kind, shape, a, b, c, extra, 1.0, -1.5, sc, 3)
    want = ft.run_kernel(kind, shape, a, b, c, extra, 1.0, -1.5, sc, 3,
                         plain=True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert int(got[1].sum()) > 0
    assert verify_matrix(want[0].cpu().numpy(), got[0].cpu().numpy(),
                         verbose=False)[0]
