"""The gallery's scripts: a reference preset rendered through the batched
kernel path and written as PNG with a manifest entry (`render_artifact`),
and the gallery held against the reference's image and the TPU's renders
(`render_gallery`). Each runs as a module from the repo root:

    python -m ray_tracing_in_one_weekend_tpu_torch.scripts.render_artifact gpu
    python -m ray_tracing_in_one_weekend_tpu_torch.scripts.render_gallery

Nothing on the render path imports them.
"""
