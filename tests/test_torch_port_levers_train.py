"""The posed train step of the torch port under both opt-in levers
(`spatial_sample` and `candidate_reuse_margin`) against the JAX package's
under both, on the CPU, at test_torch_port_train.py's shapes: the 48-vertex
ring, B=2, T=3, N=512, a 200-vertex body (under 1024: no body table is
compacted in either package), the weights of `ckpt_synth/posed_synth.npz`.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from garment4d_tpu import losses as JL
from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.data.synthetic import make_batch as jmake_batch
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.models import PosedGarmentModel as JPosed
from garment4d_tpu.train.step import body_inputs_from_batch as jbody_inputs

from garment4d_tpu_torch.train import make_posed_steps, make_state_for
from garment4d_tpu_torch.train.convert import flax_to_torch

from test_torch_port_levers import LBS_K, LEVERS, _port_model, _synth_variables
from test_torch_port_posed import _t
from test_torch_port_train import _lap_band
from torch_port_threads import one_torch_thread  # noqa: F401


def test_train_step_levers_match_jax():
    """One posed train step with both levers against JAX's with both, from
    the same weights (`posed_synth.npz`) and batch (test_torch_port_train.py's shapes: B=2,
    T=3, N=512, a 200-vertex body): every loss term within rtol 1e-4,
    every trainable parameter's gradient within 1e-4 relative L2, all
    moved, the canonical stage bitwise unchanged. The gradients reach the
    GCN through the permutation gathers and the inverse gathers (their
    backward is the scatter-add)."""
    levers = LEVERS["both"]
    ring = JAssets.synthetic(num_rings=6, ring_size=8)
    jbody = jsmpl.synthetic_smpl(num_verts=200)
    batch = jmake_batch(ring, jbody, batch_size=2, T=3, npoints=512, seed=4)
    body = jbody_inputs(batch)
    jmodel = JPosed(assets=ring, body_faces=jbody.faces, lbs_k=LBS_K, iterations=3, **levers)
    flat, variables = _synth_variables(ring, jbody)
    offs, perm = _lap_band(ring)

    def loss_fn(params):
        out = jmodel.apply(dict(variables, params=params), batch["pcd"], body, train=False)
        losses = JL.posed_stage_loss(out, batch, jnp.asarray(ring.lap_adj), jbody.faces,
                                     JL.LossWeights(), lap_offsets=offs, lap_perm=perm)
        return losses["total_loss"], losses

    (_, jlosses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    jgrads = flax_to_torch({f"params/{k}": np.asarray(v) for k, v in
                            traverse_util.flatten_dict(grads, sep="/").items()})

    model = _port_model(ring, jbody, flax_to_torch(flat), **levers).model
    state = make_state_for(model, lr=1e-3, freeze_canonical=True)
    train_step, _ = make_posed_steps(model, model.assets, jbody.faces)
    canonical = {k: v.clone() for k, v in model.canonical.state_dict().items()}
    before = {k: p.detach().clone() for k, p in model.named_parameters() if p.requires_grad}
    losses = train_step(state, {k: _t(v) for k, v in batch.items()})
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    params = dict(model.named_parameters())
    assert set(before) == {k for k in jgrads if not k.startswith("canonical.")}
    for name in before:
        want, p = jgrads[name], params[name]
        rel = float(torch.linalg.vector_norm(p.grad - want)
                    / torch.linalg.vector_norm(want).clamp_min(1e-12))
        assert rel <= 1e-4, f"{name}: relative L2 {rel}"
        assert not torch.equal(p.detach(), before[name]), name
    for k, v in model.canonical.state_dict().items():
        assert torch.equal(v, canonical[k]), k
