"""Network layer: architectures as (init, apply) modules, looked up by
module name as in nlt_tpu (``get_network_class('mlp')``)."""

from importlib import import_module


def get_network_class(name):
    return import_module("nlt_tpu_torch.networks." + name).Network
