"""PyTorch port parity, per-pixel math and scene: the port
(raytracedggx_tpu_torch) against the JAX package on the same numpy
inputs.  Scene matrices and the PCG chain must match exactly; float
shading terms at atol 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracedggx_tpu.scene import Camera as JCamera
from raytracedggx_tpu.scene import Scene as JScene
from raytracedggx_tpu.scene import default_materials as j_materials
from raytracedggx_tpu.scene.mesh import ground_cube as j_ground_cube
from raytracedggx_tpu.utils.halton import halton_table as j_halton

from raytracedggx_tpu_torch.scene import Camera, Scene, default_materials
from raytracedggx_tpu_torch.scene import ground_cube
from raytracedggx_tpu_torch.utils.halton import halton_table

ATOL = 1e-6


@pytest.fixture
def rng():
    """A fresh generator per test: the draws of conftest's shared one
    depend on which files ran before in the same worker process.  Some
    draws are ill-conditioned in float32, where the port and the reference
    may differ by more than ATOL for a cause that
    test_direction_sampling_error_is_float32_conditioning bounds."""
    return np.random.default_rng(1234)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _scenes(extra=()):
    kw = dict(pos_scale=np.array([0.5, 2.0, -1.0, 1.3], np.float32),
              extra_instances=extra)
    return (JScene(meshes=[j_ground_cube(), j_ground_cube()],
                   materials=j_materials(), **kw),
            Scene(meshes=[ground_cube(), ground_cube()],
                  materials=default_materials(), **kw))


@pytest.mark.parametrize("angle", [0.0, 0.7, 2.9])
def test_worlds_and_normal_matrices_match(angle):
    js, ts = _scenes(((3.0, 1.0, 3.0, 0.5),))
    jw = np.asarray(js.worlds(angle))
    tw = ts.worlds(angle)
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_allclose(ts.normal_matrices(tw).numpy(),
                               np.asarray(js.normal_matrices(js.worlds(angle))),
                               rtol=1e-6, atol=1e-7)


def test_view_proj_and_halton_match():
    jc, tc = JCamera(width=96, height=54), Camera(width=96, height=54)
    np.testing.assert_array_equal(tc.view_proj().numpy(),
                                  np.asarray(jc.view_proj()))
    np.testing.assert_array_equal(halton_table(1024), j_halton(1024))


def test_sample_param_bit_exact(rng):
    from raytracedggx_tpu.trace.sampling import pcg as j_pcg
    from raytracedggx_tpu.trace.sampling import sample_param as j_sp
    from raytracedggx_tpu_torch.trace.sampling import pcg, sample_param

    xs = np.array([0, 1, 2, 12345, 0xDEADBEEF, 0xFFFFFFFF], np.uint32)
    got = pcg(torch.as_tensor(xs.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_pcg(jnp.asarray(xs))))

    px = rng.integers(0, 1280, 4096).astype(np.int32)
    py = rng.integers(0, 720, 4096).astype(np.int32)
    for frame in (0, 1, 77, 255):
        want = np.asarray(j_sp(jnp.asarray(px), jnp.asarray(py), 1280,
                               jnp.uint32(frame)))
        got = sample_param(_t(px), _t(py), 1280, frame).numpy()
        np.testing.assert_array_equal(got, want)


def test_direction_sampling_and_brdf_match(rng):
    from raytracedggx_tpu.trace import brdf as jb
    from raytracedggx_tpu.trace import sampling as js
    from raytracedggx_tpu_torch.trace import brdf as tb
    from raytracedggx_tpu_torch.trace import sampling as ts

    n = rng.normal(size=(2048, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:8] = [0.0, 1.0, 0.0]                  # the up-vector switch
    xi = rng.random((2048, 2)).astype(np.float32)
    a = rng.random(2048).astype(np.float32) ** 2
    np.testing.assert_allclose(
        ts.ggx_dir(_t(a), _t(n), _t(xi)).numpy(),
        np.asarray(js.ggx_dir(jnp.asarray(a), jnp.asarray(n),
                              jnp.asarray(xi))), atol=ATOL)
    np.testing.assert_allclose(
        ts.cos_dir(_t(n), _t(xi)).numpy(),
        np.asarray(js.cos_dir(jnp.asarray(n), jnp.asarray(xi))), atol=ATOL)

    f0 = rng.random((2048, 3)).astype(np.float32)
    rough, nov, nol, voh = (rng.random(2048).astype(np.float32)
                            for _ in range(4))
    for got, want in (
            (tb.f_schlick(_t(f0), _t(voh)),
             jb.f_schlick(jnp.asarray(f0), jnp.asarray(voh))),
            (tb.vis_smith(_t(rough), _t(nov), _t(nol)),
             jb.vis_smith(jnp.asarray(rough), jnp.asarray(nov),
                          jnp.asarray(nol))),
            (tb.env_brdf_approx(_t(f0), _t(rough), _t(nov)),
             jb.env_brdf_approx(jnp.asarray(f0), jnp.asarray(rough),
                                jnp.asarray(nov))),
            (tb.d_ggx(_t(rough), _t(voh)),
             jb.d_ggx(jnp.asarray(rough), jnp.asarray(voh))),
            (tb.vis_schlick(_t(rough), _t(nov), _t(nol)),
             jb.vis_schlick(jnp.asarray(rough), jnp.asarray(nov),
                            jnp.asarray(nol))),
            (tb.vis_smith_joint_approx(_t(rough), _t(nov), _t(nol)),
             jb.vis_smith_joint_approx(jnp.asarray(rough),
                                       jnp.asarray(nov),
                                       jnp.asarray(nol)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=1e-6)



@pytest.mark.parametrize("seed", [0, 51, 259])
def test_direction_sampling_error_is_float32_conditioning(seed):
    """Where ggx_dir and cos_dir miss the reference by more than ATOL, the
    cause is float32 rounding times the sample's condition number.  The
    two frameworks' sin and cos of the same float32 angle differ by at
    most one rounding; ggx_dir amplifies an error in cos_t by
    cos_t / sin_t (sin_t = sqrt(1 - cos_t^2) cancels near the normal),
    cos_dir an error in its sphere sample by 1 / |n + u| (normalize(n + u)
    with u nearly -n).  Every direction of a draw stays within one float32
    epsilon times 1 + that number.  Seeds 51 and 259 hold the worst rows
    of a scan of 300 seeds (2.7e-6 and 3.9e-6)."""
    from raytracedggx_tpu.trace import sampling as js
    from raytracedggx_tpu_torch.trace import sampling as ts

    eps = np.finfo(np.float32).eps
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(2048, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:8] = [0.0, 1.0, 0.0]
    xi = rng.random((2048, 2)).astype(np.float32)
    a = rng.random(2048).astype(np.float32) ** 2

    phi = (np.float32(2.0 * np.pi) * xi[:, 0]).astype(np.float32)
    for torch_f, jax_f in ((torch.cos, jnp.cos), (torch.sin, jnp.sin)):
        np.testing.assert_allclose(torch_f(_t(phi)).numpy(),
                                   np.asarray(jax_f(phi)), rtol=0,
                                   atol=0.5 * eps)

    x = xi.astype(np.float64)
    cos_t = np.sqrt((1 - x[:, 1]) / (1 + (a.astype(np.float64) ** 2 - 1)
                                     * x[:, 1]))
    sin_t = np.sqrt(np.maximum(1 - cos_t * cos_t, 0.0))
    kappa_ggx = 1 + cos_t / np.maximum(sin_t, 1e-30)
    p = 2 * np.pi * x[:, 0]
    ct = 1 - 2 * x[:, 1]
    st = np.sqrt(np.maximum(1 - ct * ct, 0.0))
    u = np.stack([np.cos(p) * st, np.sin(p) * st, ct], axis=-1)
    kappa_cos = 1 + 1 / np.linalg.norm(n + u, axis=1)

    got = ts.ggx_dir(_t(a), _t(n), _t(xi)).numpy()
    want = np.asarray(js.ggx_dir(jnp.asarray(a), jnp.asarray(n),
                                 jnp.asarray(xi)))
    assert np.all(np.abs(got - want).max(axis=1) <= eps * kappa_ggx)
    got = ts.cos_dir(_t(n), _t(xi)).numpy()
    want = np.asarray(js.cos_dir(jnp.asarray(n), jnp.asarray(xi)))
    assert np.all(np.abs(got - want).max(axis=1) <= eps * kappa_cos)

def test_sh_projection_and_irradiance_match(rng):
    from raytracedggx_tpu.sh import evaluate_sh_irradiance as j_eval
    from raytracedggx_tpu.sh import project_sh9 as j_proj
    from raytracedggx_tpu_torch.sh import evaluate_sh_irradiance, project_sh9

    faces = rng.random((6, 16, 16, 3)).astype(np.float32)
    c = project_sh9(_t(faces))
    np.testing.assert_allclose(c.numpy(), np.asarray(j_proj(faces)),
                               atol=ATOL, rtol=1e-6)
    n = rng.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    np.testing.assert_allclose(
        evaluate_sh_irradiance(c, _t(n)).numpy(),
        np.asarray(j_eval(jnp.asarray(c.numpy()), jnp.asarray(n))),
        atol=ATOL)


def test_procedural_env_and_sample_env_match(rng):
    from raytracedggx_tpu.trace import env as je
    from raytracedggx_tpu_torch.trace import env as te

    jenv = je.procedural_env(16)
    tenv = te.procedural_env(16)
    for name in ("data", "offsets", "sizes", "quad", "tri"):
        want = np.asarray(getattr(jenv, name))
        got = getattr(tenv, name).numpy()
        assert got.dtype == want.dtype or name in ("offsets", "sizes")
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), atol=ATOL)
    conv = te.from_reference_arrays(*(np.asarray(x) for x in jenv[:3]),
                                    jenv.num_mips, np.asarray(jenv.quad),
                                    np.asarray(jenv.tri))
    assert conv.tri.dtype == torch.float16

    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lvl = (rng.random(4096) * 5.5 - 0.5).astype(np.float32)
    for level_j, level_t in ((0.0, 0.0), (2, 2), (jnp.asarray(lvl), _t(lvl))):
        np.testing.assert_allclose(
            te.sample_env(conv, _t(d), level_t).numpy(),
            np.asarray(je.sample_env(jenv, jnp.asarray(d), level_j)),
            atol=ATOL, rtol=1e-6)


def test_morton_sort_order_matches(rng):
    from raytracedggx_tpu.ops.traverse_pallas import sort_rays_morton as j_sort
    from raytracedggx_tpu_torch.ops.ordering import (make_block_order,
                                                     sort_rays_morton)

    o = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    active = rng.random(2000) > 0.3
    lo, hi = np.full(3, -6.0, np.float32), np.full(3, 6.0, np.float32)
    order, inv = sort_rays_morton(_t(o), _t(d), _t(lo), _t(hi),
                                  active=_t(active))
    jo, ji = j_sort(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                    jnp.asarray(hi), active=jnp.asarray(active))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ji))
    x = torch.arange(64 * 32 * 2, dtype=torch.float32).reshape(-1, 2)
    bo = make_block_order(64, 32)
    np.testing.assert_array_equal(bo.unpermute(bo.permute(x)).numpy(),
                                  x.numpy())


def test_kernel_modules_import_without_building():
    """Importing every module of the port (kernel modules included)
    compiles and loads nothing: the kernels build at first launch."""
    import importlib
    import pkgutil

    import raytracedggx_tpu_torch as pkg
    from raytracedggx_tpu_torch.ops import cuda_lib

    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
    assert cuda_lib.load_library.cache_info().currsize == 0
    assert not cuda_lib.library_path().exists() or torch.cuda.is_available()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
