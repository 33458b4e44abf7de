from sednet_tpu_torch.utils.chunked import chunked_sqdist_blocks
from sednet_tpu_torch.utils.grid_vis import (render_meshes_grid,
                                             render_pointclouds_grid,
                                             save_images_rotations,
                                             vis_batch_in_grid)
from sednet_tpu_torch.utils.vis import (COLORS_TYPE, instance_palette,
                                        save_xyz, visual_labels)

__all__ = ["COLORS_TYPE", "chunked_sqdist_blocks", "instance_palette",
           "render_meshes_grid", "render_pointclouds_grid",
           "save_images_rotations", "save_xyz", "vis_batch_in_grid",
           "visual_labels"]
