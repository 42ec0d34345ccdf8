"""Why the canonical train step's CPU parity test compiles its JAX reference
without XLA's algebraic simplifier, and compares in float64.

    JAX_PLATFORMS=cpu python tests/check_jax_algsimp.py

Not a pytest module (a few minutes on the CPU). On random weights and a
point cloud on a 1/256 grid (fp32 and float64 distances exact, so every
index decision agrees) it prints:
  1. one train-mode SA1 module (fp32): the relative L2 of its parameter
     gradients between `jax.jit(jax.grad(f))` and `jax.grad(f)`, and
     between the jitted gradient compiled with `algsimp` disabled and the
     eager one;
  2. the train-mode segmentation backbone in float64 (JAX's x64 mode) under
     a fixed cotangent on the logits: the same two readings, the port's
     float64 gradient against the eager one, and central finite differences
     of the port's loss on three elements of one BatchNorm bias beside the
     port's, eager JAX's and jitted JAX's gradient;
  3. the port's whole canonical train-step gradients in fp32 against its
     own float64 ones (B=3, T=1, N=2048): the largest relative L2.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as fnn  # noqa: E402
from flax import traverse_util  # noqa: E402

from garment4d_tpu import smpl as jsmpl  # noqa: E402
from garment4d_tpu.data.synthetic import make_batch as jmake_batch  # noqa: E402
from garment4d_tpu.models import GarmentAssets as JAssets  # noqa: E402
from garment4d_tpu.models.backbone import PointNet2SegBackbone as JBackbone  # noqa: E402
from garment4d_tpu.nn import SAModuleMSG as JSA  # noqa: E402

from garment4d_tpu_torch import losses as TL  # noqa: E402
from garment4d_tpu_torch.models import CanonicalGarmentModel  # noqa: E402
from garment4d_tpu_torch.models import GarmentAssets as TAssets  # noqa: E402
from garment4d_tpu_torch.models.backbone import PointNet2SegBackbone  # noqa: E402
from garment4d_tpu_torch.train.convert import flax_to_torch  # noqa: E402

NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}


def no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def random_variables(shapes, rng):
    flat = {}
    for coll in ("params", "batch_stats"):
        for k, v in traverse_util.flatten_dict(shapes[coll], sep="/").items():
            if k.endswith("kernel"):
                a = rng.randn(*v.shape) * np.sqrt(2.0 / v.shape[0])
            elif k.endswith("bn/var"):
                a = rng.uniform(0.5, 1.5, v.shape)
            elif k.endswith("bn/scale"):
                a = 1.0 + 0.1 * rng.randn(*v.shape)
            else:
                a = 0.1 * rng.randn(*v.shape)
            flat[f"{coll}/{k}"] = a.astype(np.float32)
    return flat


def worst_rel(a, b):
    a, b = traverse_util.flatten_dict(a, sep="/"), traverse_util.flatten_dict(b, sep="/")
    return max(float(np.linalg.norm(np.asarray(a[k]) - np.asarray(b[k]))
                     / max(np.linalg.norm(np.asarray(b[k])), 1e-300)) for k in b)


def grid_cloud(rng, B, N):
    return (np.round(rng.rand(B, N, 3) * 256) / 256).astype(np.float32)


def sa1_module(rng):
    xyz = jnp.asarray(grid_cloud(rng, 3, 2048))
    sa = JSA(npoint=1024, radii=(0.05, 0.1), nsamples=(16, 32),
             mlps=((16, 16, 32), (32, 32, 64)))
    shapes = jax.eval_shape(lambda x: sa.init(jax.random.PRNGKey(0), x, None), xyz)
    tree = traverse_util.unflatten_dict(random_variables(shapes, rng), sep="/")
    cot = jnp.asarray(rng.randn(3, 1024, 96).astype(np.float32))

    def f(p):
        (_, out), _ = sa.apply({"params": p, "batch_stats": tree["batch_stats"]}, xyz, None,
                               train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot)

    eager = jax.grad(f)(tree["params"])
    lowered = jax.jit(jax.grad(f)).lower(tree["params"])
    jit = lowered.compile()(tree["params"])
    fixed = lowered.compile(compiler_options=NO_ALGSIMP)(tree["params"])
    print(f"1. SA1 module, fp32: jit vs eager {worst_rel(jit, eager):.3e}; jit without "
          f"algsimp vs eager {worst_rel(fixed, eager):.3e}", flush=True)


def backbone_float64(rng):
    xyz = grid_cloud(rng, 3, 2048)
    labels = rng.randint(0, 7, (3, 2048))
    jbb = JBackbone(global_feat=False)
    shapes = jax.eval_shape(lambda x: jbb.init(jax.random.PRNGKey(0), x, train=False),
                            jnp.asarray(xyz))
    flat = random_variables(shapes, rng)
    with jax.enable_x64(True):
        tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      traverse_util.unflatten_dict(flat, sep="/"))

        def f(p):
            out, _ = jbb.apply({"params": p, "batch_stats": tree["batch_stats"]},
                               jnp.asarray(xyz), train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(0)})
            logp = jax.nn.log_softmax(out.sem_logits, -1)
            return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1))

        with fnn.intercept_methods(no_dropout):
            eager = jax.grad(f)(tree["params"])
            lowered = jax.jit(jax.grad(f)).lower(tree["params"])
            jit = lowered.compile()(tree["params"])
            fixed = lowered.compile(compiler_options=NO_ALGSIMP)(tree["params"])
    model = PointNet2SegBackbone()
    model.load_state_dict(flax_to_torch(flat), strict=True)
    model.double().train()
    model.dropout.p = 0.0
    x, lab = torch.from_numpy(xyz).double(), torch.from_numpy(labels)

    def loss():
        logp = torch.log_softmax(model(x, None).sem_logits, -1)
        return -torch.gather(logp, -1, lab[..., None]).mean()

    loss().backward()
    port = {n: p.grad.numpy() for n, p in model.named_parameters()}
    flat_eager = {".".join(k.split("/")[:-1] + [{"kernel": "weight", "scale": "weight",
                                                  "bias": "bias"}[k.split("/")[-1]]]):
                  (np.asarray(v).T if k.endswith("kernel") else np.asarray(v))
                  for k, v in traverse_util.flatten_dict(eager, sep="/").items()}
    port_rel = max(float(np.linalg.norm(port[n] - w) / np.linalg.norm(w))
                   for n, w in flat_eager.items())
    print(f"2. backbone, float64: jit vs eager {worst_rel(jit, eager):.3e}; jit without "
          f"algsimp vs eager {worst_rel(fixed, eager):.3e}; port vs eager {port_rel:.3e}",
          flush=True)
    name = "sa1.mlp1.layer2.bn.bias"
    param = dict(model.named_parameters())[name]
    path = ("sa1", "mlp1", "layer2", "bn", "bias")

    def at(tree_, k):
        for key in path:
            tree_ = tree_[key]
        return float(tree_[k])

    for k in range(3):
        h = 1e-6
        with torch.no_grad():
            param[k] += h
            up = float(loss())
            param[k] -= 2 * h
            down = float(loss())
            param[k] += h
        print(f"   {name}[{k}]: finite difference {(up - down) / (2 * h):.9e}, port "
              f"{port[name][k]:.9e}, JAX eager {at(eager, k):.9e}, JAX jit {at(jit, k):.9e}",
              flush=True)


def port_step_fp32_vs_float64(rng):
    jassets = JAssets.synthetic(num_rings=6, ring_size=8)
    jbody = jsmpl.synthetic_smpl(num_verts=200)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             jmake_batch(jassets, jbody, batch_size=3, T=1, npoints=2048, seed=5).items()}
    batch["pcd"] = torch.round(batch["pcd"] * 256) / 256
    torch.manual_seed(0)
    grads = []
    for dtype in (torch.float32, torch.float64):
        model = CanonicalGarmentModel(TAssets.synthetic(num_rings=6, ring_size=8))
        if grads:
            model.load_state_dict(weights)
        else:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.to(dtype).train()
        model.pointnet.dropout.p = 0.0
        b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
        out = model(b["pcd"], None)
        TL.canonical_stage_loss(out, b, jassets.faces_tri, jbody.faces,
                                TL.LossWeights())["total_loss"].backward()
        grads.append({n: p.grad.double() for n, p in model.named_parameters()})
    rel = {n: float((grads[0][n] - w).norm() / w.norm())
           for n, w in grads[1].items() if float(w.norm()) > 1e-9}
    worst = max(rel, key=rel.get)
    print(f"3. the port's canonical step, fp32 vs float64 gradients: largest relative L2 "
          f"{rel[worst]:.3e} ({worst})", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    rng = np.random.RandomState(0)
    sa1_module(rng)
    backbone_float64(rng)
    port_step_fp32_vs_float64(rng)
