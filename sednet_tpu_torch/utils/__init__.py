from sednet_tpu_torch.utils.chunked import chunked_sqdist_blocks
from sednet_tpu_torch.utils.vis import COLORS_TYPE, visual_labels

__all__ = ["COLORS_TYPE", "chunked_sqdist_blocks", "visual_labels"]
