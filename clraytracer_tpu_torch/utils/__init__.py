"""Foundation utilities: structured logging and scope timers (the JAX
package's ``utils/``; its ``pytree.py`` registers dataclasses with JAX,
work the port's ``_TensorData`` dataclasses do without registration, so it
has no counterpart here)."""

from clraytracer_tpu_torch.utils.logging import get_logger, log_error, log_info, log_warning  # noqa: F401
from clraytracer_tpu_torch.utils.timer import ScopeTimer  # noqa: F401
