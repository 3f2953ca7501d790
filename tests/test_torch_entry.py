"""The port's flagship step (``cslam_tpu_torch.entry``) against the JAX
package's (``__graft_entry__.entry``), on the CPU, on the same weights and
inputs: the JAX entry's flax ``PRNGKey(0)`` variables are carried across by
``cosplace_state_dict_from_jax``.

Descriptors: cosine >= 0.99999 (float32 convolutions summed in another
order). Top-8 indices: exactly equal, the port's search being the plain
version of K2 on the CPU; similarities within 1e-5 relative / 1e-6
absolute, the float32 rounding of a different summation order.
"""
import jax
import numpy as np
import torch

import __graft_entry__
from cslam_tpu_torch import entry as port_entry
from cslam_tpu_torch.convert import cosplace_state_dict_from_jax
from cslam_tpu_torch.models.convert import load_cosplace
from cslam_tpu_torch.ops import nns
from torch_threads import one_torch_thread  # noqa: F401


def test_frontend_step_matches_the_jax_entry():
    jfn, (variables, jimages, jbank, jinv, jn) = __graft_entry__.entry()
    jdesc, jsims, jidx = (np.asarray(a) for a in
                          jax.jit(jfn)(variables, jimages, jbank, jinv, jn))

    fn, (model, images, bank, inv_norms, n) = port_entry.entry(device="cpu")
    # the same example arguments from the same numpy generator
    np.testing.assert_array_equal(images.numpy(), np.asarray(jimages))
    np.testing.assert_array_equal(bank.numpy(), np.asarray(jbank))
    np.testing.assert_array_equal(inv_norms.numpy(), np.asarray(jinv))
    assert n == int(jn)

    load_cosplace(model, cosplace_state_dict_from_jax(variables))
    before = nns.tile_scan_launches
    desc, sims, idx = fn(model, images, bank, inv_norms, n)
    assert nns.tile_scan_launches == before   # CPU: K2's plain version
    assert desc.shape == jdesc.shape == (1, 64)
    cos = float(np.sum(desc.numpy() * jdesc)
                / (np.linalg.norm(desc.numpy()) * np.linalg.norm(jdesc)))
    assert cos >= 0.99999, cos
    assert idx.shape == jidx.shape == (1, 8)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert np.all(idx.numpy() < n)
    np.testing.assert_allclose(sims.numpy(), jsims, rtol=1e-5, atol=1e-6)

    # on the JAX entry's own descriptors the search agrees to the last bit
    # of a different summation order
    sims2, idx2 = nns.cosine_topk_fused(bank, inv_norms, n,
                                        torch.from_numpy(jdesc.copy()), 8)
    np.testing.assert_array_equal(idx2.numpy(), jidx)
    np.testing.assert_allclose(sims2.numpy(), jsims, rtol=1e-5, atol=1e-6)
