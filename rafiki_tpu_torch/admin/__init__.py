"""The control plane: job lifecycle and service deployment."""

from rafiki_tpu_torch.admin.admin import Admin  # noqa: F401
from rafiki_tpu_torch.admin.services import ServicesManager  # noqa: F401
