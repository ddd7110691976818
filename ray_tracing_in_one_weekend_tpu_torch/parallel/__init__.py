"""Pixel x sample sharding over torch.distributed (`dist.py`) and the
worker that launches local ranks (`worker.py`)."""

from ray_tracing_in_one_weekend_tpu_torch.parallel.dist import (
    DIFF_FIELDS,
    PIXEL_AXIS,
    SAMPLE_AXIS,
    Mesh,
    fetch_image,
    gather_in_order,
    init_distributed,
    make_mesh,
    render_distributed,
    render_grads,
    render_image_distributed,
    render_loss,
    scene_params,
    scene_with_params,
    sum_in_order,
    train_step,
)

__all__ = [
    "DIFF_FIELDS",
    "PIXEL_AXIS",
    "SAMPLE_AXIS",
    "Mesh",
    "fetch_image",
    "gather_in_order",
    "init_distributed",
    "make_mesh",
    "render_distributed",
    "render_grads",
    "render_image_distributed",
    "render_loss",
    "scene_params",
    "scene_with_params",
    "sum_in_order",
    "train_step",
]
