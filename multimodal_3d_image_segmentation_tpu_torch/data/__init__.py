"""Host-side data plane of the port: NIfTI IO, normalization and the
test-split input flow (numpy only)."""
from .dataset import InputData  # noqa: F401
from .nifti import read_img, read_shape, write_image  # noqa: F401
from .normalization import normalize_data, normalize_modalities  # noqa: F401
