"""Body-model pickle utilities (smplx tools equivalents, SMPL-only repo).

Counterpart of `garment4d_tpu/tools/model_pkl.py` (numpy only, no device),
on the port's chumpy-free unpickler (`smpl/model.py:_ChumpyUnpickler`).

Rebuilds the two vendored smplx maintenance scripts the pipeline's model
files may need (reference `smplx/tools/clean_ch.py:32-47` and
`smplx/tools/merge_smplh_mano.py:30-63`), without a chumpy dependency:

  * `clean`: strip chumpy objects from released model pickles, rewriting
    every chumpy array as a plain ndarray (the released SMPL_{GENDER}.pkl
    files store chumpy `Ch` buffers; cleaning them makes the pickles
    loadable in any plain-numpy environment).
  * `merge`: graft MANO hand-PCA blocks (components/coeffs/means, left and
    right) onto a body-model pickle, then clean. The Garment4D pipeline is
    SMPL-only, so this is an offline maintenance utility, not a train-path
    dependency.

CLI (flag names match the reference scripts):

    python -m garment4d_tpu_torch.tools.model_pkl clean \
        --input-models SMPL_MALE.pkl SMPL_FEMALE.pkl --output-folder out/
    python -m garment4d_tpu_torch.tools.model_pkl merge --smplh-fn SMPLH.pkl \
        --mano-left-fn MANO_LEFT.pkl --mano-right-fn MANO_RIGHT.pkl \
        --output-folder out/
"""

from __future__ import annotations

import argparse
import io
import os
import pickle
from typing import Dict

import numpy as np

from garment4d_tpu_torch.smpl.model import _ChumpyUnpickler


def _load_raw(path: str) -> Dict:
    """Unpickle a released model file (py2/latin1, chumpy-tolerant)."""
    with open(path, "rb") as f:
        return _ChumpyUnpickler(io.BytesIO(f.read()), encoding="latin1").load()


def _dechump(value):
    """Chumpy shim -> ndarray; everything else passes through unchanged
    (reference clean_ch.py:37-41 keys only on the chumpy type)."""
    if isinstance(value, _ChumpyUnpickler._ChShim):
        return np.asarray(value)
    return value


def clean_model_pkl(in_fn: str, output_folder: str = "output") -> str:
    """Reference `clean_ch.py:clean_fn` equivalent; returns the output path."""
    data = _load_raw(in_fn)
    cleaned = {key: _dechump(val) for key, val in data.items()}
    os.makedirs(output_folder, exist_ok=True)
    out_path = os.path.join(output_folder, os.path.basename(in_fn))
    with open(out_path, "wb") as f:
        pickle.dump(cleaned, f)
    return out_path


def merge_hand_models(body_fn: str, mano_left_fn: str, mano_right_fn: str,
                      output_folder: str = "output") -> str:
    """Reference `merge_smplh_mano.py:merge_models` equivalent: copy the
    body-model dict, attach the left/right hand PCA blocks under the smplx
    key scheme, clean chumpy leftovers; returns the output path."""
    body = _load_raw(body_fn)
    lhand = _load_raw(mano_left_fn)
    rhand = _load_raw(mano_right_fn)

    merged = dict(body)
    merged["hands_componentsl"] = lhand["hands_components"]
    merged["hands_componentsr"] = rhand["hands_components"]
    merged["hands_coeffsl"] = lhand["hands_coeffs"]
    merged["hands_coeffsr"] = rhand["hands_coeffs"]
    merged["hands_meanl"] = lhand["hands_mean"]
    merged["hands_meanr"] = rhand["hands_mean"]
    merged = {key: _dechump(val) for key, val in merged.items()}

    os.makedirs(output_folder, exist_ok=True)
    out_path = os.path.join(output_folder, os.path.basename(body_fn))
    with open(out_path, "wb") as f:
        pickle.dump(merged, f)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_clean = sub.add_parser("clean")
    p_clean.add_argument("--input-models", nargs="+", required=True)
    p_clean.add_argument("--output-folder", required=True)

    p_merge = sub.add_parser("merge")
    p_merge.add_argument("--smplh-fn", required=True)
    p_merge.add_argument("--mano-left-fn", required=True)
    p_merge.add_argument("--mano-right-fn", required=True)
    p_merge.add_argument("--output-folder", required=True)

    args = parser.parse_args(argv)
    os.makedirs(args.output_folder, exist_ok=True)
    if args.cmd == "clean":
        for fn in args.input_models:
            print(clean_model_pkl(fn, args.output_folder))
    else:
        print(merge_hand_models(args.smplh_fn, args.mano_left_fn,
                                args.mano_right_fn, args.output_folder))


if __name__ == "__main__":
    main()
