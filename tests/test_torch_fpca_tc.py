"""The numerics of the fpca_conv kernel's tensor-core design, on the host.

The CUDA kernel does not run here (tests/test_torch_gpu.py holds it against
its plain version on the card).  Hopper's tensor cores take no IEEE f32, so
the design splits every f32 operand of the three dot products (x and x² per
window, the W and W² planes) into bf16 parts and sums the products of the
parts in f32 accumulators.  These tests emulate that as ``fpca_tc_kernel``
does it and hold the counts against three references on the same
numpy-seeded inputs: the port's plain ``fpca_conv_basis``, the reference's
``fpca_conv_ref`` (the dense oracle) and ``fpca_conv_basis_jnp``, and the TPU
kernel itself (``fpca_conv_pallas`` in interpret mode, at one small shape).

The emulation: the pixel slots are zero-padded to 80 (five k-steps of 16);
each product runs as one pass per pair of parts and k-step, each pass's
exact sum of 16 terms rounded to nearest into the f32 accumulator, in the
kernel's order: the passes with a smaller part first, k-step by k-step, then
hi·hi k-step by k-step.  That order is the card's, not the host's, choice:
the tensor cores align the addends of a step to the largest and drop the
bits below (``_truncating_step`` models that with three bits to spare),
and with hi·hi first every small pass lands on an accumulator that already
holds the whole product.  The first build of the kernel, in that order,
failed the 5% flip limit of a 16-bit card test (H100); on this grid's
N = 75, 16-bit inputs the model puts that order at 4.8% of counts off the
plain version and the adopted one at 0.6%, against an f32 spread of 0.5%.
The window sums are taken in the kernel's order: each
of a quad's four threads sums its columns (16 kk + 8 j + 2 t, +1) in turn,
then the quad adds the four partial sums pairwise, (s0 + s1) + (s2 + s3).
The rest (f_avg estimate, gate bank, ADC) is the plain version's f32 code,
with the kernel's gate: bucket i's S(k(xg - lo)) + S(k(hi - xg)) - 1 taken
as R_i - R_(i+1), R_j = S(k(xg - j / nb)), the sigmoid of each edge shared by
the two buckets that meet there (six sigmoids for five buckets, not ten).
That form moves at most 0.13% more 16-bit counts than the plain version's
gates on the grid (at most 0.01% at 8 bits):
``test_shared_edges_stay_within_the_f32_spread``.

The limit is the port's: at most 1 ADC count apart on fewer than 5% of the
counts (ROADMAP C; ``COUNT_TOL``, ``FLIP_TOL`` in chip_smoke.py).  A split is
adopted only if it keeps within 1 count and adds at most a tenth of that
flip share (0.5%) to the f32 spread: the share by which the plain version
already differs from the same reference (for the plain version itself, the
share by which it differs from the reference's own f32 basis form).  At 16
ADC bits (lsb 15 uV) that spread alone is 0.4-0.5% of counts against the
basis forms, and 1-4% (up to 2 counts) against the dense oracle, another
algebra, so the oracle is held at 8 bits only, as in test_torch_fpca_conv.py.

The candidates, on the grid below (fpca_cnn's N = 75 and the card tests'
N = 27 and 48, each with a model fitted for its pixel count, C = 8):

- ``bf16x6``, adopted: three truncated parts and six passes, the SSD
  kernel's split.  Within 1 count everywhere; at 8 bits 0-0.03% of counts
  off the plain version, at 16 bits 0.40-0.57% against a spread of
  0.35-0.53%;
- ``bf16x3``: hi and lo rounded to nearest, three passes.  As clean as
  bf16x6 at 8 bits, but at 16 bits 1.7-2.5% of counts off the plain version
  and some by 2 counts: it breaks the limit, so it was not adopted;
- ``bf16x1``: one rounded, unsplit pass (the control), which breaks the
  limit everywhere (2 counts at 8 bits, 34-59 at 16).
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.adc import ADCConfig as JADCConfig
from repro.core.curvefit import fit_bucket_model as j_fit_bucket_model
from repro.kernels.fpca_conv import kernel as j_kernel
from repro.kernels.fpca_conv import ops as j_ops
from repro.kernels.fpca_conv.ref import fpca_conv_ref as j_fpca_conv_ref
from repro_torch.convert import bucket_model_from_dict
from repro_torch.core.adc import ADCConfig
from repro_torch.core.curvefit import PolySurface
from repro_torch.kernels.fpca_conv import kernel

COUNTS, FLIPS = 1.0, 0.05
MARGIN = FLIPS / 10
K_PAD, KSTEP = 80, 16
ROWS, CHANNELS = 2048, 8

# (part count, pairs of parts multiplied, how the parts are taken), pairs
# in the kernel's pass order
SPLITS = {
    "bf16x6": (3, ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1)), "truncate"),
    "bf16x3": (2, ((0, 0), (0, 1), (1, 0)), "round"),
    "bf16x1": (1, ((0, 0),), "round"),
}

GRID = [(75, 8), (75, 16), (27, 8), (27, 16), (48, 8), (48, 16)]


def _parts(x: torch.Tensor, k: int, how: str) -> list[torch.Tensor]:
    """f32 -> its k bf16 parts, as f32: each the bf16 rounding (``round``)
    or the top 16 bits (``truncate``) of what the earlier parts leave."""
    out, rest = [], x
    for _ in range(k):
        if how == "round":
            part = rest.bfloat16().float()
        else:
            part = (rest.view(torch.int32) & -65536).view(torch.float32)
        out.append(part)
        rest = rest - part
    return out


def _truncating_step(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, spare: int = 3) -> torch.Tensor:
    """A model of one wgmma step on the card: the accumulator and the 16
    exact products are aligned to the largest of them, the bits below 24 +
    ``spare`` are dropped, and the exact sum is rounded toward zero to f32."""
    add = torch.cat([acc.double()[:, None, :], a.double()[:, :, None] * b.double()[None, :, :]], 1)
    top = add.abs().amax(1, keepdim=True)
    quantum = torch.exp2(torch.floor(torch.log2(torch.where(top > 0, top, 1.0))) - 23 - spare)
    exact = (torch.trunc(add / quantum) * quantum).sum(1)
    near = exact.float()
    return torch.where(near.double().abs() > exact.abs(), torch.nextafter(near, torch.zeros_like(near)), near)


def _product(a: torch.Tensor, b: torch.Tensor, split: str, *, truncate: bool = False,
             hi_first: bool = False) -> torch.Tensor:
    """a (M, N) @ b (N, C) as the kernel's passes: N zero-padded to 80; the
    passes with a smaller part first, k-step by k-step, then hi·hi k-step by
    k-step (``hi_first``: each k-step's passes in the split's order, as the
    first build ran them); each pass's exact 16-term sum rounded to nearest
    into the f32 accumulator, or by ``_truncating_step``."""
    k, pairs, how = SPLITS[split]
    pad = K_PAD - a.shape[1]
    pa, pb = _parts(F.pad(a, (0, pad)), k, how), _parts(F.pad(b, (0, 0, 0, pad)), k, how)
    k_steps = range(0, K_PAD, KSTEP)
    if hi_first:
        steps = [(k0, u, v) for k0 in k_steps for u, v in pairs]
    else:
        steps = [(k0, u, v) for k0 in k_steps for u, v in pairs[1:]] + [(k0, 0, 0) for k0 in k_steps]
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0, u, v in steps:
        pu, pv = pa[u][:, k0 : k0 + KSTEP], pb[v][k0 : k0 + KSTEP]
        acc = _truncating_step(acc, pu, pv) if truncate else acc + (pu.double() @ pv.double()).float()
    return acc


def _window_sums(x: torch.Tensor) -> dict[int, torch.Tensor]:
    """rv_a = sum_j x_j^a (a = 1..3), (M, 1) each, in the kernel's order."""
    xp = F.pad(x, (0, K_PAD - x.shape[1]))
    partial = []
    for t in range(4):   # a quad's threads
        s = [torch.zeros(x.shape[0]) for _ in range(3)]
        for col in (16 * kk + 8 * j + 2 * t + e for kk in range(K_PAD // KSTEP) for j in range(2) for e in range(2)):
            v = xp[:, col]
            v2 = v * v
            s = [s[0] + v, s[1] + v2, s[2] + v2 * v]
        partial.append(s)
    return {a: ((partial[0][a - 1] + partial[1][a - 1]) + (partial[2][a - 1] + partial[3][a - 1]))[:, None]
            for a in (1, 2, 3)}


def _shared_edge_epilogue(rv, mm, planes, tables, bn) -> torch.Tensor:
    """``kernel.basis_epilogue`` with the kernel's gates, R_i - R_(i+1)."""
    model = tables.model
    a_i = torch.cat([kernel._ipow(rv[1] / tables.n_real, int(a)) for a, _ in model.f_avg.exps], dim=1)
    nb, k = model.n_buckets, model.sharpness
    edges = np.arange(nb + 1, dtype=np.float32) / np.float32(nb)

    def one_phase(p: int) -> torch.Tensor:
        cs = planes["cs"][p]
        xg = (a_i @ planes["aw"][p]) / model.v_range
        r = [1.0 / (1.0 + torch.exp(-(k * (xg - float(e))))) for e in edges]
        v = torch.zeros_like(xg)
        for i in range(nb):
            acc = torch.full_like(xg, float(tables.const[i]))
            for (a, b), c in tables.by_pair.items():
                acc = acc + float(c[i]) * (cs[b][None, :] if a == 0 else rv[a] if b == 0 else mm[p][(a, b)])
            v = v + (r[i] - r[i + 1]) * acc
        return v

    top = tables.levels - 1
    up = torch.round(one_phase(0) / tables.lsb).clamp(0, top)
    down = torch.round(one_phase(1) / tables.lsb).clamp(0, top)
    return (bn[None, :] + up - down).clamp(0, top)


def _tensor_core_counts(patches, planes, tables, bn, split: str, *, shared_edges: bool = True,
                        **order) -> torch.Tensor:
    """What the tensor-core design computes: counts (M, C).  With
    ``shared_edges`` off, the plain version's gates."""
    x = patches.float()
    xp = {1: x, 2: x * x}
    mm = [{(a, b): _product(xp[a], planes["w_pows"][p, b - 1], split, **order) for (a, b) in kernel._MM_PAIRS}
          for p in (0, 1)]
    epilogue = _shared_edge_epilogue if shared_edges else kernel.basis_epilogue
    return epilogue(_window_sums(x), mm, planes, tables, bn)


@pytest.fixture(scope="module")
def models(bucket_model) -> dict:
    """(reference model, port model) fitted for each pixel count of the grid."""
    fitted = {75: bucket_model}
    for n in (27, 48):
        fitted[n] = j_fit_bucket_model(n_pixels=n)
    return {n: (jm, bucket_model_from_dict(jm.to_dict())) for n, jm in fitted.items()}


@pytest.fixture(scope="module")
def case(models):
    """Inputs, tables and reference counts of a grid case, built once."""

    @functools.cache
    def build(n: int, bits: int) -> dict:
        jm, pm = models[n]
        rng = np.random.default_rng(n + bits)
        patches = rng.uniform(0, 1, (ROWS, n)).astype(np.float32)
        w_pos = rng.uniform(0, 1, (n, CHANNELS)).astype(np.float32)
        w_neg = np.roll(w_pos, 1, axis=1)
        bn = rng.integers(0, 30, (CHANNELS,)).astype(np.float32)
        tables = kernel.conv_tables(pm, ADCConfig(bits=bits), n, torch.device("cpu"))
        planes = kernel.weight_planes(torch.from_numpy(w_pos), torch.from_numpy(w_neg), tables)
        args = (jnp.asarray(patches), jnp.asarray(w_pos), jnp.asarray(w_neg), jm, JADCConfig(bits=bits),
                jnp.asarray(bn))
        refs = {"plain": kernel.fpca_conv_basis(torch.from_numpy(patches), planes, tables, torch.from_numpy(bn)),
                "basis_jnp": np.asarray(j_ops.fpca_conv_basis_jnp(*args))}
        if bits == 8:   # the dense oracle: another algebra, see the module docstring
            refs["ref"] = np.asarray(j_fpca_conv_ref(*args))
        return {"inputs": (torch.from_numpy(patches), planes, tables, torch.from_numpy(bn)), "refs": refs}

    return build


def _diff(got, want) -> tuple[float, float]:
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    return float(d.max()), float((d > 0).mean())


def _spread(refs: dict, name: str) -> float:
    """The f32 spread against reference ``name``: the flip share of the
    plain version there, or of the plain version against the reference's
    basis form when ``name`` is the plain version itself."""
    return _diff(refs["plain"], refs["basis_jnp" if name == "plain" else name])[1]


@pytest.mark.parametrize("n,bits", GRID)
def test_bf16x6_split_stays_within_the_f32_spread(case, n, bits):
    c = case(n, bits)
    got = _tensor_core_counts(*c["inputs"], "bf16x6")
    for name, want in c["refs"].items():
        worst, share = _diff(got, want)
        assert worst <= COUNTS and share <= _spread(c["refs"], name) + MARGIN, (name, worst, share)


@pytest.mark.parametrize("n,bits", GRID)
def test_shared_edges_stay_within_the_f32_spread(case, n, bits):
    """The kernel's gates against the plain version's on the same split
    products: they differ by f32 roundings only."""
    c = case(n, bits)
    shared = _tensor_core_counts(*c["inputs"], "bf16x6")
    worst, share = _diff(shared, _tensor_core_counts(*c["inputs"], "bf16x6", shared_edges=False))
    assert worst <= COUNTS and share <= _spread(c["refs"], "plain") + MARGIN


def test_bf16x6_split_matches_the_pallas_kernel_in_interpret_mode(models):
    jm, pm = models[75]
    rng = np.random.default_rng(3)
    patches = rng.uniform(0, 1, (64, 75)).astype(np.float32)
    w_pos = rng.uniform(0, 1, (75, CHANNELS)).astype(np.float32)
    w_neg = np.roll(w_pos, 1, axis=1)
    bn = rng.integers(0, 30, (CHANNELS,)).astype(np.float32)
    pad = ((0, 0), (0, 128 - 75))
    want = j_kernel.fpca_conv_pallas(
        jnp.asarray(np.pad(patches, pad)), jnp.asarray(np.pad(w_pos, pad[::-1])),
        jnp.asarray(np.pad(w_neg, pad[::-1])), jm, JADCConfig(), jnp.asarray(bn),
        mask=jnp.asarray(np.r_[np.ones(75), np.zeros(53)].astype(np.float32)), n_real=75,
        block_m=64, block_c=128, interpret=True,
    )
    tables = kernel.conv_tables(pm, ADCConfig(), 75, torch.device("cpu"))
    planes = kernel.weight_planes(torch.from_numpy(w_pos), torch.from_numpy(w_neg), tables)
    inputs = (torch.from_numpy(patches), planes, tables, torch.from_numpy(bn))
    worst, share = _diff(_tensor_core_counts(*inputs, "bf16x6"), want)
    assert worst <= COUNTS and share <= _diff(kernel.fpca_conv_basis(*inputs), want)[1] + MARGIN


def test_small_passes_first_keep_truncating_accumulation_within_the_spread(case):
    """Under the card's truncating accumulation (modelled) the adopted order
    stays within the margin at 16 bits; hi·hi first does not."""
    c = case(75, 16)
    spread = _spread(c["refs"], "plain")
    _, share = _diff(_tensor_core_counts(*c["inputs"], "bf16x6", truncate=True), c["refs"]["plain"])
    assert share <= spread + MARGIN
    _, share = _diff(_tensor_core_counts(*c["inputs"], "bf16x6", truncate=True, hi_first=True), c["refs"]["plain"])
    assert share > spread + MARGIN


def test_bf16x3_split_breaks_the_count_limit_at_16_bits(case):
    """bf16 hi + lo (three passes, parts rounded to nearest) was the cheaper
    candidate: clean at 8 bits, but at 16 bits it moves counts by 2, past
    the port's limit, so it was not adopted."""
    for n, bits in GRID:
        worst, _ = _diff(_tensor_core_counts(*case(n, bits)["inputs"], "bf16x3"), case(n, bits)["refs"]["plain"])
        assert worst <= COUNTS if bits == 8 else worst > COUNTS, (n, bits, worst)


@pytest.mark.parametrize("n,bits", GRID)
def test_one_unsplit_pass_breaks_the_limit(case, n, bits):
    """The control: a kernel that rounded every f32 operand to bf16 once
    (one pass) would move counts by more than 1 on every input of the grid."""
    c = case(n, bits)
    worst, _ = _diff(_tensor_core_counts(*c["inputs"], "bf16x1"), c["refs"]["plain"])
    assert worst > COUNTS


def _design_case(pm, m, n, cut=0, **model_changes):
    tables = kernel.conv_tables(dataclasses.replace(pm, **model_changes), ADCConfig(), n, torch.device("cpu"))
    return torch.zeros((m + cut, n))[cut:], tables


@pytest.mark.parametrize(
    "m,n,c,cut,chosen",
    [
        (147456, 75, 8, 0, "wgmma"),   # fpca_cnn at batch 256
        (576, 75, 8, 0, "wgmma"),      # batch 1, fewer rows than the grid holds
        (300, 27, 1, 0, "wgmma"),      # fewer pixels and channels: zero padding
        (300, 80, 8, 0, "wgmma"),      # the padded K exactly
        (300, 81, 8, 0, "simt"),       # more pixel slots than the padded K
        (300, 75, 13, 0, "wgmma"),     # two channel blocks, the second ragged
        (300, 75, 8, 1, "wgmma"),      # 300 bytes in: the wrapper copies it to an aligned buffer
        (300, 75, 8, 4, "wgmma"),      # 1200 bytes in: aligned
        (147456, 75, 12, 0, "wgmma"),  # adaptive_stream's fan-out, 8 + 4
        (147456, 75, 16, 0, "wgmma"),  # the server's fan-out, 8 + 8
        (147456, 75, 32, 0, "wgmma"),  # the pipeline's merged group, 4 x 8
        (300, 75, 40, 0, "wgmma"),     # five channel blocks
        (300, 81, 16, 0, "simt"),      # a stack past the padded K
    ],
)
def test_design_takes_the_served_shape_to_the_tensor_cores(models, m, n, c, cut, chosen):
    """The design depends on the pixel count and the bucket model alone:
    ``c``, the launch's channel count, is not an input of :func:`design`, so
    a channel-stacked launch takes the design of each of its configs."""
    assert kernel.design(*_design_case(models[75][1], m, n, cut)) == chosen


def test_design_takes_other_bucket_models_to_simt(models):
    """The epilogue is compiled for 5 buckets and 15 f_avg terms."""
    pm = models[75][1]
    assert kernel.design(*_design_case(pm, 64, 75)) == "wgmma"
    four = dict(bucket_coeffs=pm.bucket_coeffs[:4], v_centers=pm.v_centers[:4], centers=pm.centers[:4])
    assert kernel.design(*_design_case(pm, 64, 75, **four)) == "simt"
    fewer = PolySurface(coeffs=pm.f_avg.coeffs[:10], exps=pm.f_avg.exps[:10])
    assert kernel.design(*_design_case(pm, 64, 75, f_avg=fewer)) == "simt"
