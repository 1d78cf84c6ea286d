from .architectures import HartleyMHABlock, HartleyMHASeg, VNetDS  # noqa: F401
from .hnosegxs import HNOSegXS, HNOXSBlock  # noqa: F401
