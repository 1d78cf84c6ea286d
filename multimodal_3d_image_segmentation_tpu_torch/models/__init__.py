from .architectures import (HartleyMHABlock, HartleyMHASeg,  # noqa: F401
                            NeuralOperatorBlock, NeuralOperatorSeg, VNetDS)
from .hnosegxs import HNOSegXS, HNOXSBlock  # noqa: F401
