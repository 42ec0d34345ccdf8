"""The reference's torch checkpoints -> the port's state_dicts.

Counterpart of `garment4d_tpu/train/torch_import.py`. The reference's
released weights (`pretrain/{skirt,trousers,tshirt}.ckpt`, reference
`utils/train_utils.py:100-112`) are one `torch.save` file
`{epoch, model_state, optimizer_state, other_state}` keyed by the
reference's module names (`PCALBSGarmentUseSegEncoderSeg` and its MGN
variant, `PCAGarmentEncoderSeg` for the canonical stage). The port names
its modules by the Flax paths (`train/convert.py`), so a key maps by the
JAX package's table followed by the Flax-to-torch leaf rename:

  * a `module.` prefix (DDP) is dropped; `PCA_garment_encoder.` becomes
    `canonical.`;
  * Conv1d/Conv2d 1x1 weights (out, in, 1[, 1]) -> Linear weights (out, in),
    reshaped, not transposed;
  * Linear weights (out, in) are kept as they are;
  * pygcn GraphConvolution weights (in, out) are kept as they are, which
    is how the port's `GraphConvolution` holds them;
  * pt_utils' `bn.bn.<param>` -> `bn.<param>`; `num_batches_tracked` is
    neither loaded nor reported (the port's BatchNorm has a fixed momentum).

The file is read with `torch.load(weights_only=True)`; a file whose other
entries hold globals outside torch's safe list is read by a numpy-only
zip reader that resolves tensors and plain containers and stands an inert
object in for every other global.
"""

from __future__ import annotations

import codecs
import collections
import pickle
import re
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# reading the file
# ---------------------------------------------------------------------------


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """{key: tensor} of a torch checkpoint's `model_state`, or of a bare
    state_dict, keys as the file has them."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        ckpt = _load_torch_zip_numpy(path)
    if isinstance(ckpt, dict) and ckpt.get("model_state") is not None:
        ckpt = ckpt["model_state"]
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: neither a state_dict nor a checkpoint with `model_state`")
    out = {}
    for k, v in ckpt.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach()
        elif isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(v)
        else:
            raise ValueError(f"{path}: {k!r} is a {type(v).__name__}, not a tensor")
    return out


# torch storage-class name -> numpy dtype
_TORCH_STORAGE_DTYPES = {
    "FloatStorage": np.float32, "DoubleStorage": np.float64,
    "HalfStorage": np.float16, "LongStorage": np.int64,
    "IntStorage": np.int32, "ShortStorage": np.int16,
    "CharStorage": np.int8, "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
}
# the numpy globals a pickled array or scalar needs
_NUMPY_GLOBALS = {"_reconstruct", "scalar", "ndarray", "dtype"}


class _Inert:
    """What the numpy-only reader makes of a global it does not resolve:
    built from any arguments and state, holding none of them."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


def _load_torch_zip_numpy(path: str):
    """Numpy-only reader of torch's zipfile format (every torch >= 1.6
    file): `<name>/data.pkl` is a pickle whose tensors are persistent ids
    `('storage', <StorageClass>, key, location, numel)`, and
    `<name>/data/<key>` holds each storage's little-endian bytes. Tensors
    come back as numpy arrays (`as_strided` over their storage); dicts,
    lists, tuples and numpy arrays as themselves; any other global as an
    inert object (`_Inert`), so a checkpoint whose optimizer or other state
    pickles such objects still yields its tensors. Legacy (non-zip) files
    raise ValueError."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path!r} is not a torch zipfile checkpoint")
    with zipfile.ZipFile(path) as zf:
        try:
            pkl_name = next(n for n in zf.namelist() if n.endswith("data.pkl"))
        except StopIteration:
            raise ValueError(f"{path!r} is not a torch zipfile checkpoint (no data.pkl)")
        root = pkl_name[: -len("data.pkl")]

        class _StorageRef:
            def __init__(self, dtype, key):
                self.dtype = dtype
                self.key = key

            def read(self):
                return np.frombuffer(zf.read(f"{root}data/{self.key}"), dtype=self.dtype)

        def _rebuild_tensor_v2(storage, offset, size, stride, *_):
            flat = storage.read()
            if not size:
                return np.array(flat[offset])
            itemsize = flat.dtype.itemsize
            return np.lib.stride_tricks.as_strided(
                flat[offset:], shape=tuple(size),
                strides=tuple(s * itemsize for s in stride)).copy()

        def _rebuild_parameter(data, *_):
            return data

        class _StorageClass:
            def __init__(self, name):
                self.name = name

        class _Unpickler(pickle.Unpickler):
            def find_class(self, module, name):
                if module == "torch._utils" and name in ("_rebuild_tensor_v2",
                                                         "_rebuild_tensor"):
                    return _rebuild_tensor_v2
                if module == "torch._utils" and name == "_rebuild_parameter":
                    return _rebuild_parameter
                if module == "torch" and name in _TORCH_STORAGE_DTYPES:
                    return _StorageClass(name)
                if module == "torch" and name == "Size":
                    return tuple
                if (module, name) == ("collections", "OrderedDict"):
                    return collections.OrderedDict
                if (module, name) == ("_codecs", "encode"):  # a pickled array's bytes
                    return codecs.encode
                if (module in ("numpy", "numpy.core.multiarray", "numpy._core.multiarray")
                        and name in _NUMPY_GLOBALS):
                    import importlib

                    return getattr(importlib.import_module(module), name)
                return type(name, (_Inert,), {"__module__": module})

            def persistent_load(self, pid):
                kind, storage_cls, key = pid[0], pid[1], pid[2]
                if kind != "storage":
                    raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
                name = (storage_cls.name if isinstance(storage_cls, _StorageClass)
                        else getattr(storage_cls, "__name__", str(storage_cls)))
                return _StorageRef(np.dtype(_TORCH_STORAGE_DTYPES[name]), key)

        with zf.open(pkl_name) as f:
            return _Unpickler(f).load()


# ---------------------------------------------------------------------------
# the key map
# ---------------------------------------------------------------------------

_SA_NAME = {"0": "sa1", "1": "sa2", "2": "sa3"}
_FP_NAME = {"0": "fp1", "1": "fp2", "2": "fp3"}
_GE_NAME = {"0": "garment_sa1", "1": "garment_sa2"}
_PCA_HEAD = {"0": "pca_head0", "1": "pca_head0", "3": "pca_head1",
             "4": "pca_head1", "6": "pca_head2"}
_PE_LINEAR = {"0": "linear0", "2": "linear1"}
_MGN_LINEAR = {"0": "linear0", "2": "linear1", "4": "linear2"}
_PARAM = {"weight": "weight", "bias": "bias"}
_BN_PARAM = {"weight": "weight", "bias": "bias", "running_mean": "running_mean",
             "running_var": "running_var"}


def _leaf(table: dict, name: str, key: str) -> str:
    try:
        return table[name]
    except KeyError:
        raise KeyError(f"unmapped reference key: {key}") from None


def _conv_or_bn(key: str, base: Tuple[str, ...], rest) -> Tuple[str, str]:
    """pt_utils' `conv.<param>` or `bn.bn.<param>` under `base`."""
    if rest and rest[0] == "conv" and len(rest) == 2:
        return ".".join(base + ("conv", _leaf(_PARAM, rest[1], key))), "conv"
    if rest and rest[0] == "bn" and len(rest) in (2, 3):
        return ".".join(base + ("bn", _leaf(_BN_PARAM, rest[-1], key))), "none"
    raise KeyError(f"unmapped reference key: {key}")


def _reference_target(key: str) -> Optional[Tuple[str, str]]:
    """(the port's key, how the tensor is reshaped: 'conv' or 'none') of
    one reference key; None for `num_batches_tracked`; KeyError for a key
    the map does not know."""
    if key.endswith("num_batches_tracked"):
        return None
    parts = key.split(".")
    if parts[0] == "module":  # DDP prefix (train_utils.py:117)
        parts = parts[1:]
    prefix: Tuple[str, ...] = ()
    if parts and parts[0] == "PCA_garment_encoder":
        prefix, parts = ("canonical",), parts[1:]
    try:
        return _map_parts(key, prefix, parts)
    except (IndexError, ValueError):
        raise KeyError(f"unmapped reference key: {key}") from None


def _map_parts(key: str, prefix: Tuple[str, ...], parts) -> Tuple[str, str]:
    head = parts[0]
    # ---- canonical-stage modules ----
    if head == "pointnet":
        sub = parts[1]
        if sub == "SA_modules":  # SA_modules.{k}.mlps.{s}.layer{i}.{conv|bn}...
            if parts[3] != "mlps":
                raise KeyError(f"unmapped reference key: {key}")
            base = prefix + ("pointnet", _leaf(_SA_NAME, parts[2], key), f"mlp{parts[4]}",
                             parts[5])
            return _conv_or_bn(key, base, parts[6:])
        if sub == "Middle_modules":
            # one PointnetSAModule, not a ModuleList (reference
            # `pointnet2encoder.py:81`): Middle_modules.mlps.{s}.layer{i}...
            if parts[2] != "mlps":
                raise KeyError(f"unmapped reference key: {key}")
            base = prefix + ("pointnet", "middle", f"mlp{parts[3]}", parts[4])
            return _conv_or_bn(key, base, parts[5:])
        if sub == "FP_modules":  # FP_modules.{k}.mlp.layer{i}...
            if parts[3] != "mlp":
                raise KeyError(f"unmapped reference key: {key}")
            base = prefix + ("pointnet", _leaf(_FP_NAME, parts[2], key), "mlp", parts[4])
            return _conv_or_bn(key, base, parts[5:])
        if sub == "FC_layer":
            base = prefix + ("pointnet", _leaf({"0": "head0", "2": "head1"}, parts[2], key))
            return _conv_or_bn(key, base, parts[3:])
        raise KeyError(f"unmapped reference key: {key}")
    if head == "GarmentEncoder":  # GarmentEncoder.{k}.mlps.{s}.layer{i}...
        if parts[2] != "mlps":
            raise KeyError(f"unmapped reference key: {key}")
        base = prefix + (_leaf(_GE_NAME, parts[1], key), f"mlp{parts[3]}", parts[4])
        return _conv_or_bn(key, base, parts[5:])
    if head == "GarmentSummarize":  # GarmentSummarize.mlps.{s}.layer{i}...
        if parts[1] != "mlps":
            raise KeyError(f"unmapped reference key: {key}")
        base = prefix + ("garment_summarize", f"mlp{parts[2]}", parts[3])
        return _conv_or_bn(key, base, parts[4:])
    if head == "PCAEncoder" and len(parts) == 3:
        idx, param = parts[1], parts[2]
        name = _leaf(_PCA_HEAD, idx, key)
        if idx in ("0", "3", "6"):  # Conv1d
            return ".".join(prefix + (name, "conv", _leaf(_PARAM, param, key))), "conv"
        return ".".join(prefix + (name, "bn", _leaf(_BN_PARAM, param, key))), "none"
    if prefix:  # the posed stage's own modules have no stage prefix
        raise KeyError(f"unmapped reference key: {key}")
    # ---- posed-stage modules ----
    m = re.fullmatch(r"(body|garment)_positional_encoding(\d)", head)
    if m and len(parts) == 3:
        return (f"{m.group(1)}_pe{m.group(2)}.{_leaf(_PE_LINEAR, parts[1], key)}."
                f"{_leaf(_PARAM, parts[2], key)}", "none")
    m = re.fullmatch(r"temporal_qkv_(\d)", head)
    if m and len(parts) == 2 and int(m.group(1)) >= 1:
        return f"temporal_qkv{int(m.group(1)) - 1}.{_leaf(_PARAM, parts[1], key)}", "none"
    m = re.fullmatch(r"lbs_graph_regress(\d)", head)
    if m and len(parts) == 3 and int(m.group(1)) >= 1 and parts[1].isdigit():
        return (f"gcn{int(m.group(1)) - 1}_{parts[1]}.{_leaf(_PARAM, parts[2], key)}",
                "none")  # pygcn weight is already (in, out)
    if head == "displacement_encoder" and len(parts) == 3:  # MGN variant
        return (f"displacement.{_leaf(_MGN_LINEAR, parts[1], key)}."
                f"{_leaf(_PARAM, parts[2], key)}", "none")
    raise KeyError(f"unmapped reference key: {key}")


def map_reference_key(key: str) -> Optional[str]:
    """The port's state_dict key of one reference key: None for
    `num_batches_tracked`, KeyError for a key the map does not know."""
    target = _reference_target(key)
    return None if target is None else target[0]


def _transform(value: torch.Tensor, how: str) -> torch.Tensor:
    if how == "conv" and value.dim() > 2:  # (out, in, 1[, 1]) -> (out, in)
        return value.reshape(value.shape[0], value.shape[1])
    return value


def map_reference_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{the port's key: tensor reshaped as the map says} of every key of a
    reference state_dict but `num_batches_tracked`; KeyError for a key
    the map does not know."""
    out = {}
    for key, value in state_dict.items():
        target = _reference_target(key)
        if target is not None:
            out[target[0]] = _transform(value, target[1])
    return out


def is_reference_named(state_dict: Dict[str, torch.Tensor]) -> bool:
    """Whether any key of `state_dict` (other than `num_batches_tracked`)
    is one the reference map knows."""
    for key in state_dict:
        try:
            if _reference_target(key) is not None:
                return True
        except KeyError:
            pass
    return False


def import_reference_state_dict(state_dict: Dict[str, torch.Tensor], model: torch.nn.Module,
                                strict: bool = False) -> Dict[str, list]:
    """Load a reference state_dict into `model` through the key map:
    returns {"loaded": the file's keys loaded, "skipped": the file's keys
    not loaded}; `num_batches_tracked` is in neither. Tolerant like the
    reference's `load_pretrained_model` (`train_utils.py:123-153`): a key
    the map does not know, one whose target the model lacks, or whose
    shape differs is skipped; with `strict` each of these raises
    (KeyError, KeyError, ValueError)."""
    own = model.state_dict()
    matched, loaded, skipped = {}, [], []
    for key, value in state_dict.items():
        try:
            target = _reference_target(key)
        except KeyError:
            if strict:
                raise
            skipped.append(key)
            continue
        if target is None:
            continue
        name, how = target
        value = _transform(value, how)
        if name not in own:
            if strict:
                raise KeyError(f"{key}: {type(model).__name__} has no {name}")
            skipped.append(key)
            continue
        if tuple(own[name].shape) != tuple(value.shape):
            if strict:
                raise ValueError(f"{key}: shape {tuple(value.shape)}, {name} is "
                                 f"{tuple(own[name].shape)}")
            skipped.append(key)
            continue
        matched[name] = value
        loaded.append(key)
    model.load_state_dict(matched, strict=False)
    return {"loaded": loaded, "skipped": skipped}
