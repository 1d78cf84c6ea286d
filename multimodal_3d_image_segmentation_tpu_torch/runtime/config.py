"""Config system: INI files with Python-literal values, the port of
``multimodal_3d_image_segmentation_tpu/runtime/config.py`` (importing that
module would run the JAX runtime package's ``__init__``).

Same dialect as the upstream ``experiments/utils.py``: ``ConfigParser``
with ``ExtendedInterpolation``, every value parsed by ``ast.literal_eval``,
inline ``#`` comments stripped at parse time, and the raw config text kept
under ``"config"``.
"""
from __future__ import annotations

import ast
import os
from collections import OrderedDict
from configparser import ConfigParser, ExtendedInterpolation
from io import StringIO

__all__ = ["get_config", "save_config"]


def get_config(config_file, source=None):
    """Parse a config file (path or StringIO) into {section: {key: val}}."""
    config = ConfigParser(interpolation=ExtendedInterpolation(),
                          inline_comment_prefixes=("#",))
    if isinstance(config_file, StringIO):
        config.read_file(config_file, source)
    else:
        if not config.read(config_file):
            raise FileNotFoundError(config_file)
        source = config_file

    output = OrderedDict()
    for section in config.sections():
        output[section] = OrderedDict()
        for k, v in config.items(section):
            try:
                output[section][k] = ast.literal_eval(v)
            except ValueError as e:
                raise ValueError(str(e) + "\n%s: %s" % (k, v))

    output["config_file"] = (os.path.basename(source)
                             if source is not None else None)
    output["config"] = StringIO()
    config.write(output["config"])
    return output


def save_config(config_args, output_dir):
    """Copy the raw config text into the run directory."""
    with open(os.path.join(output_dir, config_args["config_file"]), "w") as f:
        f.write(config_args["config"].getvalue())
