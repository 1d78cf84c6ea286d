from .architectures import VNetDS  # noqa: F401
from .hnosegxs import HNOSegXS, HNOXSBlock  # noqa: F401
