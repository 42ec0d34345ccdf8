"""CLOTH3D sequence dataset, on the reference's on-disk format.

Counterpart of `garment4d_tpu/data/cloth3d.py` (reference
`utils/dataloader.py`: SeqPointSMPLDataset + SeqPointSMPL_collate_fn):

  * the host reads the files and computes the sampling indices exactly like
    `random_sample_pcd` (`dataloader.py:26-48`, a RandomState(0) replay per
    call), in numpy, so `raw_item` is safe on loader threads;
  * `finalize_batch` runs on the batch's device: the three per-frame SMPL
    forwards (posed / T-pose / zero-pose, `dataloader.py:186-214`) batched
    over B*T for each gender, then the point-cloud assembly (shuffled body
    vertices, garment points offset by the root joint and subsampled, one
    final resample, `dataloader.py:215-232`) as index gathers.

On-disk layout (reference README.md:58-72):
  <root>/CLOTH3D/<seq>/<frame>/{smpl_param.pkl, garment_flist.txt, <G>.bin}
  <root>/CLOTH3D/<seq>/gender.pkl
  <root>/CLOTH3D_template/<seq>/<Garment>.obj
  <root>/<G>_reg/<seq>/{PCACoeff_SS.pkl, remesh_weights.pkl}
  <root>/list/*.txt
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import pickle
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from garment4d_tpu_torch.data import native
from garment4d_tpu_torch.data.synthetic import smpl_triple_forward
from garment4d_tpu_torch.models.assets import LABEL_DICT
from garment4d_tpu_torch.smpl import SmplModel


def sample_choice(num_in: int, n: int, retain_order: bool = False) -> np.ndarray:
    """The index choice of reference `random_sample_pcd`
    (`dataloader.py:26-48`): np.random.seed(0) per call, so the choice is a
    pure function of (num_in, n, retain_order). A local RandomState(0)
    draws bit-identically to the reference's global `np.random.seed(0)`."""
    r = np.random.RandomState(0)
    if n == num_in:
        choice = np.arange(num_in, dtype=np.int32)
    elif n < num_in:
        choice = r.choice(np.arange(num_in, dtype=np.int32), n, replace=False)
        if retain_order:
            choice = np.sort(choice)
    else:
        replace = n - num_in > num_in
        choice = np.concatenate([
            np.arange(num_in, dtype=np.int32),
            r.choice(np.arange(num_in, dtype=np.int32), n - num_in,
                     replace=replace)])
    if not retain_order:
        r.shuffle(choice)
    return choice


def _body_shuffle_choice(num_verts: int, garment_count: int,
                         npoints: int) -> np.ndarray:
    """The body-vertex shuffle of reference `dataloader.py:216-218`. It uses
    the global numpy RNG state left by the preceding
    `random_sample_pcd(garment_cloud, npoints)` (reseeded with 0, then a
    choice and a shuffle), so it replays those draws for the same sizes on
    a local RandomState(0) before shuffling."""
    r = np.random.RandomState(0)
    if npoints != garment_count:
        if npoints < garment_count:
            choice = r.choice(
                np.arange(garment_count, dtype=np.int32), npoints, replace=False)
        else:
            replace = npoints - garment_count > garment_count
            choice = np.concatenate([
                np.arange(garment_count, dtype=np.int32),
                r.choice(np.arange(garment_count, dtype=np.int32),
                         npoints - garment_count, replace=replace)])
    else:
        choice = np.arange(garment_count, dtype=np.int32)
    r.shuffle(choice)
    out = np.arange(num_verts, dtype=np.int32)
    r.shuffle(out)
    return out


@functools.lru_cache(maxsize=1024)
def _cached_sample_choice(num_in: int, n: int,
                          retain_order: bool = False) -> np.ndarray:
    """`sample_choice` memoised: a pure function of the sizes, so caching
    changes no value and skips the MT19937 replay. Read-only results."""
    out = sample_choice(num_in, n, retain_order)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=1024)
def _cached_body_shuffle(num_verts: int, garment_count: int,
                         npoints: int) -> np.ndarray:
    """`_body_shuffle_choice` memoised (a pure function of the sizes)."""
    out = _body_shuffle_choice(num_verts, garment_count, npoints)
    out.setflags(write=False)
    return out


def z_rotation_matrix(zrot: float) -> np.ndarray:
    c, s = np.cos(zrot), np.sin(zrot)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


@dataclasses.dataclass
class Cloth3dPaths:
    root: str
    cloth3d_folder: str = "CLOTH3D"
    garment_folder: str = "Skirt_reg"
    template_prefix: str = "CLOTH3D_template"

    @property
    def smpl_param_prefix(self) -> str:
        return os.path.join(self.root, self.cloth3d_folder)


class Cloth3dDataset:
    """Sequence-window dataset over the CLOTH3D directory tree.

    The per-sequence reads are cached in a least-recently-used cache: a hit
    moves the sequence to the back. (The JAX package's cache evicts in
    insertion order whatever was used since, a fault of that package.)"""

    def __init__(self, paths: Cloth3dPaths, file_list: str, garment_name: str,
                 T: int, npoints: int, pca_dim: int = 64, is_train: bool = True,
                 exclude_list: Optional[str] = None, body_verts: int = 6890,
                 rng: Optional[np.random.RandomState] = None):
        self.paths = paths
        self.garment_name = garment_name
        self.T = T
        self.npoints = npoints
        self.pca_dim = pca_dim
        self.body_verts = body_verts
        # an entry is ~0.3-0.5 MB at CLOTH3D sizes: bounded, so an epoch
        # over thousands of sequences evicts instead of growing
        self._seq_cache: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        self._seq_cache_max = 1024
        self._seq_cache_lock = threading.Lock()
        rng = rng or np.random.RandomState()

        with open(file_list) as f:
            model_list = f.read().splitlines()
        excluded = set()
        if exclude_list:
            with open(exclude_list) as f:
                excluded = {l.rstrip() for l in f.read().splitlines()}

        # frames grouped by sequence prefix (reference `dataloader.py:67-77`)
        seqs: List[List[str]] = []
        last_pref = None
        for n in model_list:
            pref = n.split("/")[0]
            if pref in excluded:
                continue
            if pref != last_pref:
                last_pref = pref
                seqs.append([])
            seqs[-1].append(n)

        # T-windows (reference `dataloader.py:78-99`): train = random start
        # and a random skip per step; eval = contiguous chunks padded with
        # the last frame
        self.windows: List[List[str]] = []
        for seq in seqs:
            if len(seq) < T:
                continue
            sample_time = int(len(seq) / T) + 1
            max_skip = min(int(len(seq) / T), 5)
            for i in range(sample_time):
                if is_train:
                    skips = [rng.randint(1, max_skip + 1) for _ in range(T - 1)]
                    start = rng.randint(0, len(seq) - sum(skips))
                    win = [seq[start]]
                    acc = start
                    for s in skips:
                        acc += s
                        win.append(seq[acc])
                    self.windows.append(win)
                else:
                    # kept from the reference (dataloader.py:82-99): when
                    # len(seq) is an exact multiple of T, sample_time counts
                    # one window too many and the last eval window is T
                    # copies of the final frame, which weighs that frame in
                    # the eval means
                    win = seq[i * T: i * T + T]
                    if len(win) < T:
                        win = win + [seq[-1]] * (T - len(win))
                    self.windows.append(win)

    def __len__(self) -> int:
        return len(self.windows)

    def _seq_dir(self, frame: str) -> str:
        return os.path.join(self.paths.smpl_param_prefix, frame)

    def _sequence_static(self, seq_name: str):
        """Per-sequence data that no window changes (gender, PCA
        coefficients, remesh weights, the raw template vertices before the
        z-rotation), read once and cached."""
        with self._seq_cache_lock:
            hit = self._seq_cache.get(seq_name)
            if hit is not None:
                self._seq_cache.move_to_end(seq_name)
                return hit
        seq_root = os.path.join(self.paths.smpl_param_prefix, seq_name)
        with open(os.path.join(seq_root, "gender.pkl"), "rb") as f:
            gender = pickle.load(f)
        if gender not in (0, 1):
            # the reference raises for unknown genders (dataloader.py:199-214)
            raise NotImplementedError(
                f"{seq_name}: gender {gender!r} (expected 0=female, 1=male)")
        reg_dir = os.path.join(self.paths.root, self.paths.garment_folder,
                               seq_name)
        with open(os.path.join(reg_dir, "PCACoeff_SS.pkl"), "rb") as f:
            pca_coeff = np.asarray(pickle.load(f)[: self.pca_dim], np.float32)
        with open(os.path.join(reg_dir, "remesh_weights.pkl"), "rb") as f:
            remesh = pickle.load(f)
        remesh_ind = np.stack([r["ind"] for r in remesh])
        remesh_w = np.stack([r["w"] for r in remesh])
        # an absolute template_prefix wins the join; a relative one resolves
        # under <root>
        template_file = os.path.join(self.paths.root,
                                     self.paths.template_prefix, seq_name,
                                     f"{self.garment_name}.obj")
        tmpl_v_raw, _ = native.parse_obj(template_file)
        for a in (pca_coeff, remesh_ind, remesh_w, tmpl_v_raw):
            a.setflags(write=False)
        entry = (gender, pca_coeff, remesh_ind, remesh_w, tmpl_v_raw)
        with self._seq_cache_lock:
            self._seq_cache[seq_name] = entry
            self._seq_cache.move_to_end(seq_name)
            while len(self._seq_cache) > self._seq_cache_max:
                self._seq_cache.popitem(last=False)
        return entry

    def raw_item(self, index: int) -> Dict[str, np.ndarray]:
        """Host-side part of __getitem__: file reads and sampling indices,
        as numpy arrays. The SMPL forwards and the point-cloud assembly run
        on the device in `finalize_batch`."""
        win = self.windows[index]
        seq_name = win[0].split("/")[0]
        N = self.npoints
        gender, pca_coeff, remesh_ind, remesh_w, tmpl_v_raw = \
            self._sequence_static(seq_name)

        poses, shapes = [], []
        garment_pts, garment_labels, garment_choice = [], [], []
        named_garment, body_shuffles = [], []
        inv_zrot_mat = None
        for frame in win:
            fdir = self._seq_dir(frame)
            with open(os.path.join(fdir, "smpl_param.pkl"), "rb") as f:
                param = pickle.load(f)
            poses.append(param["pose"].astype(np.float32).reshape(72))
            shapes.append(param["shape"].astype(np.float32).reshape(10))
            inv_zrot_mat = z_rotation_matrix(param["zrot"])

            with open(os.path.join(fdir, "garment_flist.txt")) as f:
                gfiles = [l.rstrip() for l in f.readlines()]
            pts_list, lab_list, by_name = [], [], {}
            all_bufs = native.read_bin_batch(
                [os.path.join(fdir, gf) for gf in gfiles])
            for gf, pts in zip(gfiles, all_bufs):
                gname = os.path.basename(gf)[:-5]  # strip "N.bin", reference [:-5]
                pts_list.append(pts)
                lab_list.append(np.full(pts.shape[0], LABEL_DICT[gname], np.int32))
                by_name[gname] = pts
            all_pts = np.concatenate(pts_list, 0) @ inv_zrot_mat
            all_lab = np.concatenate(lab_list, 0)
            choice = _cached_sample_choice(all_pts.shape[0], N)
            garment_pts.append(all_pts[choice].astype(np.float32))
            garment_labels.append(all_lab[choice])
            garment_choice.append(_cached_sample_choice(N, N // 2))
            body_shuffles.append(
                _cached_body_shuffle(self.body_verts, all_pts.shape[0], N))

            named = by_name[self.garment_name] @ inv_zrot_mat
            named_garment.append(
                native.barycentric(named, remesh_ind, remesh_w))

        tmpl_v = tmpl_v_raw @ inv_zrot_mat
        tmpl_v = native.barycentric(tmpl_v, remesh_ind, remesh_w)

        # final pcd resample (a pure function of the input sizes)
        final_choice = _cached_sample_choice(self.body_verts + N // 2, N)

        return dict(
            gender=np.int32(gender),
            pose=np.stack(poses),                     # (T, 72)
            beta=np.stack(shapes),                    # (T, 10)
            garment_pcd=np.stack(garment_pts),        # (T, N, 3) garment cloud
            garment_pcd_label=np.stack(garment_labels),  # (T, N)
            garment_subsample=np.stack(garment_choice),  # (T, N//2)
            garment=np.stack(named_garment),          # (T, Vg, 3) remeshed GT
            garment_template_vertices=tmpl_v,         # (Vg, 3)
            pca_coeff=pca_coeff,
            final_choice=final_choice,                # (N,)
            body_shuffle=np.stack(body_shuffles),     # (T, Vb)
        )

    def collate(self, items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


_FINALIZE_KEYS = (
    "pose", "beta", "gender", "body_shuffle", "garment_pcd",
    "garment_subsample", "garment_pcd_label", "final_choice", "garment",
    "garment_template_vertices", "pca_coeff",
)
_INDEX_KEYS = ("body_shuffle", "garment_subsample", "final_choice")


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`. To the card through pinned memory and an
    asynchronous copy, so the caller's thread does not wait for the work
    queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@torch.no_grad()
def finalize_batch(raw: Dict[str, np.ndarray],
                   body_models: Dict[str, SmplModel]) -> Dict[str, torch.Tensor]:
    """Batch completion on the body models' device: the triple SMPL forward
    for each gender, the gender pick, the body shuffle, the root offset,
    the garment subsample and the final resample.

    raw: collated numpy dict from `Cloth3dDataset`; body_models: {'male',
    'female'} on one device. Returns the 16-key training batch (reference
    `dataloader.py:262-294`); `J_regressor` and `lbs_weights` are each one
    (B, J, Vb) / (B, Vb, J) pick expanded over T. Reads nothing back to the
    host."""
    male, female = body_models["male"], body_models["female"]
    device = male.v_template.device
    arrays = {}
    for k in _FINALIZE_KEYS:
        t = host_to_device(raw[k], device)
        arrays[k] = t.long() if k in _INDEX_KEYS else t
    B, T = arrays["pose"].shape[:2]
    pose, beta = arrays["pose"], arrays["beta"]

    out_m = smpl_triple_forward(male, pose, beta)
    out_f = smpl_triple_forward(female, pose, beta)
    is_male = arrays["gender"] == 1

    def pick(m, f):
        return torch.where(is_male.reshape((B,) + (1,) * (m.ndim - 1)), m, f)

    body = {k: pick(out_m[k], out_f[k]) for k in out_m}
    body_v = body["smpl_vertices"]  # (B, T, Vb, 3)
    Vb = body_v.shape[2]
    root = body["smpl_root_joints"]  # (B, T, 3)

    shuffle = arrays["body_shuffle"]  # (B, T, Vb)
    shuffled_body = torch.gather(body_v, 2, shuffle[..., None].expand(B, T, Vb, 3))
    # garment points: offset by each frame's root joint, subsampled to N//2
    g_pcd = arrays["garment_pcd"] + root[:, :, None, :]
    sub = arrays["garment_subsample"]  # (B, T, N//2)
    g_sel = torch.gather(g_pcd, 2, sub[..., None].expand(*sub.shape, 3))
    g_lab = torch.gather(arrays["garment_pcd_label"], 2, sub)

    pcd_all = torch.cat([shuffled_body, g_sel], dim=2)  # (B, T, Vb + N//2, 3)
    lab_all = torch.cat([
        torch.ones((B, T, Vb), dtype=torch.int32, device=device),
        g_lab.to(torch.int32)], dim=2)
    final = arrays["final_choice"]  # (B, N)
    n = final.shape[1]
    pcd = torch.gather(pcd_all, 2, final[:, None, :, None].expand(B, T, n, 3))
    labels = torch.gather(lab_all, 2, final[:, None, :].expand(B, T, n)) - 1

    J = male.J_regressor.shape[0]
    return dict(
        pose=pose,
        beta=beta,
        pcd=pcd,
        pcd_label=labels,
        garment=arrays["garment"],
        garment_template_vertices=arrays["garment_template_vertices"],
        pca_coeff=arrays["pca_coeff"],
        J_regressor=pick(male.J_regressor[None], female.J_regressor[None])[:, None]
        .expand(B, T, J, Vb),
        lbs_weights=pick(male.lbs_weights[None], female.lbs_weights[None])[:, None]
        .expand(B, T, Vb, J),
        **body,
    )
