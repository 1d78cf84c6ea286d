from .hnosegxs import HNOSegXS, HNOXSBlock  # noqa: F401
