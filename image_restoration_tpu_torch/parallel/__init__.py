from .tiling import tile_image, tiled_apply, untile_image

__all__ = ["tile_image", "tiled_apply", "untile_image"]
