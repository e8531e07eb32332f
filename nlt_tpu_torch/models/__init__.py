"""Model registry: by-name dynamic class lookup."""

from importlib import import_module


def get_model_class(name):
    mod = import_module("nlt_tpu_torch.models." + name)
    return mod.Model
