"""Utilities of the port."""

import logging

LOGGER = logging.getLogger("bsyolo_tpu_torch")
