"""The port's logger; entry points configure the handler."""
import logging

log = logging.getLogger("voxe_tpu_torch")
