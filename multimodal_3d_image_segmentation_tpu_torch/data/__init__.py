"""Host-side data plane of the port: NIfTI IO, normalization, the input
flows and the augmentation (numpy only)."""
from .dataset import InputData  # noqa: F401
from .nifti import (read_img, read_shape, read_spacing,  # noqa: F401
                    write_image)
from .normalization import normalize_data, normalize_modalities  # noqa: F401
