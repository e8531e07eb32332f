"""Network layer: architectures as (init, apply) modules."""
