"""PyTorch port parity, the bounce sort.

``sort_rays_morton``'s order must equal the JAX package's (dead | direction
class | Morton, one 32-bit key) at ``dir_bits`` 3 and 6, at live shares
from an all-dead wave (a band of sky rows) to an all-live one (a frame
filled by the model), and at a ray count that is a power of two and one
that is not (a 67x37 band); its inverse must undo it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracedggx_tpu.ops.traverse_pallas import sort_rays_morton as j_sort

from raytracedggx_tpu_torch.ops.ordering import sort_rays_morton


@pytest.mark.parametrize("n", [2048, 67 * 37])
@pytest.mark.parametrize("live_share", [0.0, 0.3, 0.7, 1.0])
@pytest.mark.parametrize("dir_bits", [3, 6])
def test_sort_order_equals_reference(dir_bits, live_share, n):
    rng = np.random.default_rng(1234 + n)
    o = rng.uniform(-8.0, 8.0, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:64] = np.round(d[:64])                     # axis-aligned, ties
    live = rng.uniform(size=n) < live_share
    lo, hi = np.full(3, -8.0, np.float32), np.full(3, 8.0, np.float32)
    j_order, _ = j_sort(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                        jnp.asarray(hi), active=jnp.asarray(live),
                        dir_bits=dir_bits)
    order, inv = sort_rays_morton(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(lo),
        torch.as_tensor(hi), active=torch.as_tensor(live), dir_bits=dir_bits)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    assert torch.equal(order[inv], torch.arange(n))
    with pytest.raises(ValueError):
        sort_rays_morton(torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(lo), torch.as_tensor(hi),
                         dir_bits=4)
