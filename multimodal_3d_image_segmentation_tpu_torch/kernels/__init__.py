from ._build import LAUNCHES, library, reset_launch_counts  # noqa: F401
from .conv_in import conv_in_plain, conv_in_s2d  # noqa: F401
from .freq_chain import freq_chain_plain, fused_freq_chain  # noqa: F401
from .tail_resize import (fused_tail_softmax, tail_plain,  # noqa: F401
                          tail_supported)
