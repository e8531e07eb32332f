"""The 1024^2 configuration of dragon_sss and the fused stages' split
share: the configuration is dragon_sss's recipe at another UV (and
camera) size with caches for the whole pool, and the share reads the
kernels by name from a traced slice."""

import types

from benchmark.harness import registry, trace


def test_uv1024_is_dragon_sss_at_1024():
    """Only the sizes, the caps, the name, the source of the 1024^2 UV
    size, the assumptions and the limits differ from dragon_sss; every
    width is the recipe's."""
    base = registry.config("dragon_sss")
    cfg = registry.config("dragon_sss_uv1024")
    changed = {k for k in set(base) | set(cfg) if base.get(k) != cfg.get(k)}
    assert changed <= {"name", "source", "uvh", "uvw", "imh", "imw",
                       "cache_device_mb", "cache_static_mb", "assumed",
                       "limits"}
    assert cfg["source"].endswith("/data_gen/README.md")
    assert {cfg[k] for k in ("uvh", "uvw", "imh", "imw")} == {1024}
    assert cfg["reduced"] == [] and cfg["depth"] == 1024
    assert cfg["limits"].keys() == base["limits"].keys()
    # Both caps hold the pool: 4x the 512^2 bytes (1.51 GB of inputs,
    # 5.58 GB of statics at 252 examples) in MiB.
    assert cfg["cache_device_mb"] << 20 > 4 * 1.51e9
    assert cfg["cache_static_mb"] << 20 > 4 * 5.58e9


def _run(*kernels):
    """A run whose traced slice holds one 1 ms kernel of each name."""
    device = [(name, "kernel", i * 1e-3, (i + 1) * 1e-3)
              for i, name in enumerate(kernels)]
    return types.SimpleNamespace(slice=trace.Slice(device, [], (0.0, 1.0)))


def test_stage_split_share_reads_kernels_by_route():
    read = registry.metric_reader("stage_split_share.train")
    split = ("void contract_split_kernel<__nv_bfloat16, 2>",
             "expand_split_kernel")
    tiled = ("contract_kernel<float>", "void expand_kernel<__nv_bfloat16>")
    assert read(_run(*split, "ampere_sgemm")) == 100.0
    assert read(_run(*tiled, "scatter_add_rows_kernel")) == 0.0
    assert read(_run(split[0], tiled[1], tiled[0], split[1])) == 50.0
    assert read(_run("ampere_sgemm", "scatter_add_rows_kernel")) is None
    assert read(types.SimpleNamespace(slice=None)) is None
