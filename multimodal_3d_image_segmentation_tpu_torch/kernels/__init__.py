from ._build import LAUNCHES, library, reset_launch_counts  # noqa: F401
from .conv3 import conv3, conv3_plain  # noqa: F401
from .conv_in import conv_in_plain, conv_in_s2d  # noqa: F401
from .freq_chain import freq_chain_plain, fused_freq_chain  # noqa: F401
from .tail_resize import (fused_tail_softmax, tail_plain,  # noqa: F401
                          tail_supported)
from .tower_block import fused_tower_block, tower_block_plain  # noqa: F401
from .tower_block_s import (fused_tower_block_s,  # noqa: F401
                            tower_block_s_plain)
