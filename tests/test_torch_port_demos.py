"""The port's demos (`garment4d_tpu_torch/demos/`) against the JAX
package's (`demos/`), on the CPU.

- Each demo's data stream bitwise the JAX demo's: the JAX demo runs in
  this process with `jax.numpy.asarray` recording the numpy arrays its own
  lines hand to JAX (the SBM graph's features, adjacency and labels; the
  segmentation batches; the SMPL betas and pose), held against the port
  demo's generators. The segmentation demo's backbone is replaced by a
  one-layer stand-in there, so its batches are read without compiling
  PointNet++ (its loop stops after three batches).
- The SMPL demo's OBJ and joints PLY within 1e-5 of the JAX demo's run
  with `--cpu` (as `tests/test_cli.py` runs it), faces equal, the preview
  image written.
- The two training demos a few steps on the CPU at a small size, the
  loss falling; the GCN demo at its defaults through its gate.
"""

import collections
import importlib.util
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
from flax import linen as nn

from garment4d_tpu_torch.data.obj_io import read_obj
from garment4d_tpu_torch.demos import gcn_node_demo, pointcloud_seg_demo, smpl_demo
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stop(Exception):
    pass


def _jax_demo(name):
    path = os.path.join(REPO, "demos", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_demo_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module, path


def _run_recording(monkeypatch, name, argv, limit=None):
    """Run the JAX demo `name`'s main with `argv`, recording every numpy
    array its own lines pass to `jnp.asarray`; stop after `limit` of them."""
    module, path = _jax_demo(name)
    recorded, asarray = [], jnp.asarray

    def recording(a, *args, **kwargs):
        if sys._getframe(1).f_code.co_filename == path and isinstance(a, np.ndarray):
            if limit is not None and len(recorded) == limit:
                raise _Stop
            recorded.append(np.array(a))
        return asarray(a, *args, **kwargs)

    monkeypatch.setattr(jnp, "asarray", recording)
    monkeypatch.setattr(sys, "argv", [path] + argv)
    try:
        module.main()
    except _Stop:
        pass
    return recorded


def _bitwise(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_gcn_stream_and_gate(monkeypatch, capsys):
    """The SBM graph bitwise the JAX demo's (one run of it at its defaults,
    through its own gate), then the port demo at its defaults through its
    gate (accuracy > 0.9)."""
    feats, adj, labels = _run_recording(monkeypatch, "gcn_node_demo", ["--cpu"])
    got = gcn_node_demo.sbm_graph(300)
    for a, b in zip(got, (feats, adj, labels)):
        assert _bitwise(a, b)
    monkeypatch.undo()
    history = gcn_node_demo.main(["--cpu"])
    assert history[-1][1] > 0.9 and len(history) == 100
    assert capsys.readouterr().out.rstrip().endswith("OK")


def test_seg_stream(monkeypatch):
    """The JAX demo's first three batches (its init batch and two steps'),
    B=2, N=256, bitwise the port's generator from RandomState(0)."""
    import garment4d_tpu.models.backbone as jbackbone

    Out = collections.namedtuple("Out", "sem_logits")

    class StandIn(nn.Module):
        num_classes: int = 2
        global_feat: bool = False

        @nn.compact
        def __call__(self, x, train=False):
            self.variable("batch_stats", "count", jnp.zeros, ())
            return Out(nn.Dense(self.num_classes)(x))

    monkeypatch.setattr(jbackbone, "PointNet2SegBackbone", StandIn)
    want = _run_recording(monkeypatch, "pointcloud_seg_demo",
                          ["--cpu", "--steps", "3", "--npoints", "256"], limit=6)
    rng = np.random.RandomState(0)
    got = [a for _ in range(3) for a in pointcloud_seg_demo.make_batch(rng, 2, 256)]
    assert len(want) == 6
    for a, b in zip(got, want):
        assert _bitwise(a, b)


def test_seg_trains():
    """Six steps at B=1, N=512 on the CPU: finite, the loss of the last
    two steps below the first two's."""
    history = pointcloud_seg_demo.train(6, 512, 1, "cpu", log_every=100)
    losses = [h[0] for h in history]
    assert all(np.isfinite(losses)) and max(losses[-2:]) < min(losses[:2])


def test_gcn_trains():
    """Ten steps on a 60-node graph: the loss falls step by step."""
    history = gcn_node_demo.train(*gcn_node_demo.sbm_graph(60), 10, "cpu", log_every=100)
    losses = [h[0] for h in history]
    assert all(b < a for a, b in zip(losses, losses[1:]))


@pytest.mark.parametrize("pose", ["random", "zero"])
def test_smpl_demo_matches_jax(monkeypatch, tmp_path, pose):
    argv = ["--cpu", "--plot-joints", "--pose", pose]
    betas, theta = _run_recording(monkeypatch, "smpl_demo", argv + ["--out", str(tmp_path / "jax")])
    monkeypatch.undo()
    got = smpl_demo.sample_inputs(0, 10, True, pose)
    assert _bitwise(got[0], betas) and _bitwise(got[1], theta)
    smpl_demo.main(argv + ["--out", str(tmp_path / "port")])
    (jv, jf), (tv, tf) = (read_obj(str(tmp_path / tag / "body.obj"))[:2] for tag in ("jax", "port"))
    np.testing.assert_array_equal(np.asarray(tf), np.asarray(jf))
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    joints = [np.loadtxt(str(tmp_path / tag / "joints.ply"), skiprows=_ply_header(
        str(tmp_path / tag / "joints.ply"))) for tag in ("jax", "port")]
    assert joints[0].shape == joints[1].shape == (24, 3)
    np.testing.assert_allclose(joints[1], joints[0], atol=1e-5)
    assert os.path.getsize(str(tmp_path / "port" / "body_preview.png")) > 0


def _ply_header(path):
    with open(path) as f:
        for i, line in enumerate(f):
            if line.strip() == "end_header":
                return i + 1
    raise AssertionError(f"{path}: no end_header")
