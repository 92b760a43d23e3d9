"""3xTF32, the arithmetic of B1 and B2 at the wgmma tiles, against the JAX
package (``ft_sgemm_tpu_torch/ops/tf32x3.py``, CPU emulation).

(a) The split's ``cvt.rna.tf32.f32`` emulation, bit for bit, on hand-picked
values. (b) The emulated 3xTF32 product against ``ft_sgemm_tpu.make_sgemm``
(Pallas in interpret mode) at the 128x128x128 ``test`` tile, within the
reference's ``verify_matrix`` (0.01 absolute AND relative). (c) That
accumulator through B2's weighted check, faults in place: the per-tile
``detections`` / ``uncorrectable`` grids must EQUAL the JAX package's, and
C must pass ``verify_matrix`` against the oracle on correctable tiles. (d)
The Python mirror of the wgmma accumulator's fragment map. The card test
(marker ``cuda``) holds the kernel's accuracy gate at 1024: B1's error
against a float64 product at most twice cuBLAS FP32's; another holds B1
and B2 at the wgmma tiles to their plain versions where K is shorter than
one pipeline stage or ends in a partial one.
"""

import numpy as np
import pytest
import torch

import ft_sgemm_tpu as jft
from ft_sgemm_tpu.configs import KernelShape as JKernelShape
from ft_sgemm_tpu.injection import InjectionSpec as JInjectionSpec
from ft_sgemm_tpu.utils.matrices import generate_random_matrix
from ft_sgemm_tpu_torch import SHAPES
from ft_sgemm_tpu_torch.injection import InjectionSpec
from ft_sgemm_tpu_torch.interop import from_reference
from ft_sgemm_tpu_torch.ops import ft_sgemm as ft
from ft_sgemm_tpu_torch.ops import tf32x3
from ft_sgemm_tpu_torch.ops.common import pad_to, scalar_operand, strict_fp32
from ft_sgemm_tpu_torch.utils.matrices import verify_matrix

JTEST = JKernelShape("test", 128, 128, 128, (64, 64, 8, 16, 32, 4, 4))
WGMMA_TILES = ("large", "tall", "huge")


def _f32(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


def _bits(x: torch.Tensor) -> int:
    return int(x.view(torch.int32).item()) & 0xFFFFFFFF


# (input bits, cvt.rna.tf32.f32 result bits): TF32 keeps the top 10
# mantissa bits; the low 13 round to nearest, ties away from zero.
RNA_CASES = {
    "exact": (0x3F800000, 0x3F800000),
    "tie_away_from_even": (0x3F801000, 0x3F802000),    # 1 + 2^-11
    "tie_odd": (0x3F803000, 0x3F804000),
    "below_tie": (0x3F800FFF, 0x3F800000),
    "above_tie": (0x3F801001, 0x3F802000),
    "negative_tie": (0xBF801000, 0xBF802000),           # away from zero
    "subnormal_tie": (0x00001000, 0x00002000),
    "subnormal_below": (0x00000FFF, 0x00000000),
    "carry_into_exponent": (0x3FFFF000, 0x40000000),
    "largest_tf32": (0x7F7FE000, 0x7F7FE000),
    "largest_finite_to_inf": (0x7F7FFFFF, 0x7F800000),
    "inf": (0x7F800000, 0x7F800000),
    "minus_inf": (0xFF800000, 0xFF800000),
}


@pytest.mark.parametrize("case", list(RNA_CASES))
def test_tf32_rna_bits(case):
    x, want = RNA_CASES[case]
    got = tf32x3.tf32_rna(torch.tensor([_f32(x)]))
    assert _bits(got) == want, f"{_bits(got):#010x} != {want:#010x}"


def test_tf32_rna_keeps_nan():
    x = torch.tensor([_f32(0x7FC00000), _f32(0x7F800001), _f32(0xFFFFFFFF)])
    assert torch.isnan(tf32x3.tf32_rna(x)).all()


def test_split_is_two_tf32_numbers_summing_to_x():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 2.0 ** rng.integers(-60, 60, 4096)).astype(np.float32))
    hi, lo = tf32x3.split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # hi carries 11 significant bits, lo the next 11: the rest is < 2^-21 |x|.
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    assert (lo.abs() <= 2.0 ** -11 * x.abs()).all()


@pytest.mark.parametrize("dims,alpha,beta", [
    ((256, 256, 256), 1.0, -1.5),
    ((200, 136, 300), 1.0, -1.5),
    ((128, 256, 128), 2.0, 0.0),
    ((130, 70, 129), -0.5, 1.0),
])
def test_tf32x3_product_matches_jax(dims, alpha, beta):
    m, n, k = dims
    rng = np.random.default_rng(sum(dims))
    a, b, c = (generate_random_matrix(r, s, rng=rng)
               for r, s in ((m, k), (n, k), (m, n)))
    want = np.asarray(jft.make_sgemm(JTEST, alpha=alpha, beta=beta)(a, b, c))
    got = tf32x3.sgemm_tf32x3(*(torch.from_numpy(x) for x in (a, b, c)),
                              alpha, beta).numpy()
    ok, nbad, first = verify_matrix(want, got, verbose=False)
    assert ok, f"{nbad} elements off, first at {first}"
    # Far inside the tolerance: within FP32 accumulation noise of JAX's.
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("case", ["clean", "reference_like", "dense",
                                  "adversarial_same_column"])
def test_tf32x3_weighted_check_matches_jax(case):
    m, n, k = 256, 256, 512
    rng = np.random.default_rng(3)
    a, b, c = (generate_random_matrix(r, s, rng=rng)
               for r, s in ((m, k), (n, k), (m, n)))
    kw = {"clean": {}, "dense": dict(enabled=True, every=1),
          "adversarial_same_column": dict(enabled=True, every=1, col_stride=0)}
    jinj = (JInjectionSpec.reference_like(k, JTEST.bk) if case == "reference_like"
            else JInjectionSpec(**kw[case]))
    jres = jft.make_ft_sgemm(JTEST, strategy="weighted")(a, b, c, jinj)
    jdet, junc = np.asarray(jres.detections), np.asarray(jres.uncorrectable)

    shape = SHAPES["test"]
    ops = from_reference(a, b, c, jinj.as_operand(), 9500.0, device="cpu")
    expm = ft._expected_col_checksums(ops.a, ops.b, shape.bm)
    out, det, unc = tf32x3.ft_weighted_tf32x3(
        ops.a, ops.b, ops.c, shape, 1.0, -1.5,
        scalar_operand(ops.inject, ops.thresholds), expm)
    np.testing.assert_array_equal(det.numpy(), jdet)
    np.testing.assert_array_equal(unc.numpy(), junc)
    ok_tiles = np.repeat(np.repeat(junc == 0, 128, 0), 128, 1)
    want = np.asarray(jft.sgemm_reference(a, b, c))
    assert verify_matrix(want[ok_tiles], out.numpy()[ok_tiles],
                         verbose=False)[0]
    if case == "clean":
        assert jdet.sum() == 0 and junc.sum() == 0
    if case == "adversarial_same_column":
        assert unc.sum() > 0  # reported, never silent


@pytest.mark.parametrize("name", WGMMA_TILES)
def test_fragment_map_is_a_bijection_onto_the_tile(name):
    shape = SHAPES[name]
    rc = tf32x3.wgmma_fragment_map(shape.bm, shape.bn).reshape(-1, 2)
    assert rc.shape[0] == shape.bm * shape.bn
    flat = rc[:, 0] * shape.bn + rc[:, 1]
    assert torch.equal(flat.sort().values, torch.arange(shape.bm * shape.bn))


@pytest.mark.parametrize("name", WGMMA_TILES)
def test_column_shuffle_lanes_share_columns(name):
    # The weighted check's column sums combine lanes l ^ 4, l ^ 8, l ^ 16
    # of one warp: they must hold the same columns, in distinct rows.
    shape = SHAPES[name]
    rc = tf32x3.wgmma_fragment_map(shape.bm, shape.bn)
    t = torch.arange(rc.shape[0])
    for off in (4, 8, 16):
        partner = (t // 32) * 32 + (t % 32 ^ off)
        assert torch.equal(rc[partner, :, 1], rc[:, :, 1])
        assert not (rc[partner, :, 0] == rc[:, :, 0]).any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", WGMMA_TILES)
def test_accuracy_gate_on_card(cuda_device, name):
    from ft_sgemm_tpu_torch.ops.sgemm import sgemm_kernel

    shape = SHAPES[name]
    rng = np.random.default_rng(12)
    a, b, c = (pad_to(torch.from_numpy(generate_random_matrix(1024, 1024, rng=rng))
                      .to(cuda_device), *mult)
               for mult in ((shape.bm, shape.bk), (shape.bn, shape.bk),
                            (shape.bm, shape.bn)))
    strict_fp32()
    exact = a.double() @ b.double().T - 1.5 * c.double()
    kernel = (sgemm_kernel(a, b, c, shape, 1.0, -1.5).double() - exact).abs().max()
    cublas = (torch.addmm(c, a, b.T, beta=-1.5).double() - exact).abs().max()
    assert kernel <= 2 * cublas, f"kernel {float(kernel)} vs cuBLAS {float(cublas)}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", WGMMA_TILES + ("test",))
@pytest.mark.parametrize("k", [8, 40, 1000])
def test_wgmma_ragged_k_on_card(cuda_device, name, k):
    # K below one 32-column stage, and a last stage that TMA zero-fills.
    from ft_sgemm_tpu_torch.ops.sgemm import sgemm_kernel, sgemm_plain

    shape = SHAPES[name]
    rng = np.random.default_rng(k)
    a, b, c = (pad_to(torch.from_numpy(generate_random_matrix(r, s, rng=rng))
                      .to(cuda_device), *mult)
               for (r, s), mult in zip(((130, k), (70, k), (130, 70)),
                                       ((shape.bm, shape.bk), (shape.bn, shape.bk),
                                        (shape.bm, shape.bn))))
    want = sgemm_plain(a, b, c, 1.0, -1.5)
    assert verify_matrix(want.cpu().numpy(),
                         sgemm_kernel(a, b, c, shape, 1.0, -1.5).cpu().numpy(),
                         verbose=False)[0]
    sc = scalar_operand(InjectionSpec.reference_like(k, shape.bk), (9500.0,) * 3)
    expm = ft._expected_col_checksums(a, b, shape.bm)
    got = ft.ft_weighted_kernel(a, b, c, expm, shape, 1.0, -1.5, sc)
    plain = ft.ft_weighted_plain(a, b, c, shape, 1.0, -1.5, sc, expm=expm)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
    assert verify_matrix(plain[0].cpu().numpy(), got[0].cpu().numpy(),
                         verbose=False)[0]
