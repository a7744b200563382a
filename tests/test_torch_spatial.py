"""PyTorch port parity, spatial filters (K2 reflection, K3 diffuse).

The plain versions of K2 and K3 — one separable pass each axis — and the
full reflection and diffuse filters against the JAX package's XLA
stencils and its Pallas kernels in interpret mode, on the same numpy
G-buffers, at the bar of tests/test_spatial_pallas.py (atol 2e-5,
rtol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracedggx_tpu.denoise import spatial as js

from raytracedggx_tpu_torch.denoise import (diffuse_spatial_filter,
                                            reflection_spatial_filter, tm)
from raytracedggx_tpu_torch.ops import spatial_cuda as ks

H, W = 24, 32
TOL = dict(atol=2e-5, rtol=1e-4)


def _gbuffers(rng):
    """tests/test_spatial_pallas.py:gbuffers plus radiance inputs."""
    normal = rng.random((H, W, 4)).astype(np.float32)
    n = normal[..., :3] * 2 - 1
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normal[..., :3] = n * 0.5 + 0.5
    normal[..., 3] = (rng.random((H, W)) > 0.2).astype(np.float32)
    rough = rng.random((H, W)).astype(np.float32)
    depth = (0.3 + 0.6 * rng.random((H, W))).astype(np.float32)
    metal = rng.choice([0.0, 0.5, 1.0], size=(H, W)).astype(np.float32)
    refl = (rng.random((H, W, 3)) * 3).astype(np.float32)
    diff = (rng.random((H, W, 3)) * 2).astype(np.float32)
    flt_rfl = rng.random((H, W, 4)).astype(np.float32)
    return dict(normal=normal, rough=rough, depth=depth, metal=metal,
                refl=refl, diff=diff, flt_rfl=flt_rfl)


def _pair(g):
    return ({k: jnp.asarray(v) for k, v in g.items()},
            {k: torch.as_tensor(v) for k, v in g.items()})


@pytest.mark.parametrize("axis", [1, 0])
def test_plain_passes_match_reference_stencils(rng, axis):
    j, t = _pair(_gbuffers(rng))
    src = tm(t["refl"])
    want, _ = js._reflection_pass(jnp.asarray(src.numpy()), j["normal"],
                                  j["rough"], j["depth"], axis, W, H)
    got = ks.reflection_pass_plain(src, t["normal"], t["rough"], t["depth"],
                                   W, H, axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    src = tm(t["diff"])
    want, _ = js._diffuse_pass(jnp.asarray(src.numpy()), j["normal"],
                               j["metal"], j["depth"], axis)
    got = ks.diffuse_pass_plain(src, t["normal"], t["metal"], t["depth"],
                                axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _k3_arithmetic(src_tm, normal, metal, depth, axis):
    """K3's arithmetic (csrc/spatial.cu:diffuse_pass_kernel) in float32
    torch: the tap's gate folded into its decoded normal, clip(n.n, 0,
    1)^32 by five squarings, the depth weight exp(-|dz| * (z * 4)) with
    z * 4 formed once, taps summed in the order i = -16..16."""
    n_c = normal[..., :3] * 2.0 - 1.0
    z4 = depth * 4.0
    mu = torch.zeros_like(src_tm)
    wsum = torch.zeros_like(metal)
    for nrm, s, dep, mtl in zip(ks._taps(normal, axis), ks._taps(src_tm, axis),
                                ks._taps(depth, axis), ks._taps(metal, axis)):
        gate = ((nrm[..., 3] > 0.0) & (mtl < 1.0)).to(torch.float32)
        n = (nrm[..., :3] * 2.0 - 1.0) * gate[..., None]
        x = torch.clamp(torch.sum(n_c * n, dim=-1), 0.0, 1.0)
        for _ in range(5):
            x = x * x
        w = x * torch.exp(-torch.abs(depth - dep) * z4)
        mu = mu + s * w[..., None]
        wsum = wsum + w
    return mu / torch.clamp(wsum, min=1e-30)[..., None]


@pytest.mark.parametrize("axis", [1, 0])
def test_k3_squarings_hold_the_plain_pass(rng, axis):
    """x^32 by five squarings (about 16 ulp from the exact power) keeps
    K3 at the filters' bar against diffuse_pass_plain on both axes."""
    _, t = _pair(_gbuffers(rng))
    src = tm(t["diff"]).contiguous()
    got = _k3_arithmetic(src, t["normal"], t["metal"], t["depth"], axis)
    want = ks.diffuse_pass_plain(src, t["normal"], t["metal"], t["depth"],
                                 axis)
    assert float(want.abs().max()) > 0.1
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_filters_match_reference(rng, ref_impl):
    j, t = _pair(_gbuffers(rng))
    interp = ref_impl == "pallas"
    want_r = js.reflection_spatial_filter(j["refl"], j["normal"], j["rough"],
                                          j["depth"], W, H, impl=ref_impl,
                                          interpret=interp)
    want_d = js.diffuse_spatial_filter(j["diff"], j["flt_rfl"], j["normal"],
                                       j["metal"], j["depth"], impl=ref_impl,
                                       interpret=interp)
    for impl in ("xla", "cuda"):      # CPU tensors: "cuda" takes the plain
        got_r = reflection_spatial_filter(t["refl"], t["normal"], t["rough"],
                                          t["depth"], W, H, impl=impl)
        got_d = diffuse_spatial_filter(t["diff"], t["flt_rfl"], t["normal"],
                                       t["metal"], t["depth"], impl=impl)
        np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **TOL)
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)


def test_wrappers_take_plain_versions_for_cpu_tensors(rng):
    """On CPU tensors the K2/K3 wrappers return their plain version's
    result and launch nothing."""
    _, t = _pair(_gbuffers(rng))
    before = (ks.reflection_pass.launches, ks.diffuse_pass.launches)
    src = tm(t["refl"]).contiguous()
    for axis in (0, 1):
        torch.testing.assert_close(
            ks.reflection_pass(src, t["normal"], t["rough"], t["depth"], W,
                               H, axis),
            ks.reflection_pass_plain(src, t["normal"], t["rough"],
                                     t["depth"], W, H, axis),
            rtol=0, atol=0)
        torch.testing.assert_close(
            ks.diffuse_pass(src, t["normal"], t["metal"], t["depth"], axis),
            ks.diffuse_pass_plain(src, t["normal"], t["metal"], t["depth"],
                                  axis), rtol=0, atol=0)
    assert (ks.reflection_pass.launches, ks.diffuse_pass.launches) == before


@pytest.mark.parametrize("hw", [(720, 1280), (54, 96)])
def test_gaussian_table_equals_plain_weights(hw):
    """K2's table holds the plain pass's Gaussian weight bit for bit for
    every radius br up to br_max = 0.05 * height, read at (br, |i|)."""
    h, w = hw
    rough = torch.linspace(0.0, 1.0, h * w).reshape(h, w)
    br = ks.gaussian_radius(rough, w, h)
    assert int(br.max()) == int(h * 0.05)
    assert torch.equal(torch.unique(br), torch.arange(int(h * 0.05) + 1.0))
    table = ks.gaussian_table(h * 0.05, "cpu")
    assert table.shape == (int(h * 0.05) + 1, ks.RADIUS + 1)
    sigma = (br + 1.0) / 3.0
    for i in range(-ks.RADIUS, ks.RADIUS + 1):
        a = float(abs(i)) / sigma                  # reflection_pass_plain
        want = torch.exp(-0.5 * a * a)
        assert torch.equal(table[br.long(), abs(i)], want), i
