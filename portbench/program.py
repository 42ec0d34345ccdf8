"""The system under test: the port's objects built from the benchmark's
raw inputs, through the port's own API, and the names of its variables.

Only this module and the paths import `garment4d_tpu_torch`.
"""

from __future__ import annotations

import re

import torch


def assets(template: dict, name: str):
    """The port's `GarmentAssets` of the template (the port derives its
    graph operators itself)."""
    from garment4d_tpu_torch.models import GarmentAssets

    return GarmentAssets.build(name=name, template_v=template["verts"],
                               faces=[tuple(int(i) for i in f) for f in template["faces"]],
                               pca_components=template["pca_components"],
                               pca_mean=template["pca_mean"],
                               pca_explained=template["pca_explained"],
                               pca_scale=template["pca_scale"])


def body_model(body: dict):
    """The port's `SmplModel` over the body's tensors (`inputs.body_on`)."""
    from garment4d_tpu_torch.smpl import SmplModel

    return SmplModel(v_template=body["v_template"], shapedirs=body["shapedirs"],
                     posedirs=body["posedirs"], J_regressor=body["J_regressor"],
                     lbs_weights=body["lbs_weights"], parents=body["parents"],
                     faces=body["faces"])


def body_inputs(batch: dict):
    from garment4d_tpu_torch.train.step import body_inputs_from_batch

    return body_inputs_from_batch(batch)


def launch_counts():
    """The port's kernel launch counters (a live Counter)."""
    from garment4d_tpu_torch import ops

    return ops.launch_counts


_GCN = re.compile(r"gcn\d+_\d+$")


def flax_name(name: str, tensor: torch.Tensor):
    """A port parameter's Flax path and its value in the Flax layout: a
    Linear's (out, in) weight is the transposed kernel, a BatchNorm's
    weight its scale, a GCN layer's (in, out) weight stays as it is."""
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    if leaf == "weight" and parent == "bn":
        parts[-1] = "scale"
    elif leaf == "weight" and not _GCN.match(parent):
        parts[-1] = "kernel"
        tensor = tensor.t()
    return "params/" + "/".join(parts), tensor
