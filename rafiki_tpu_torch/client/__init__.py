"""The Python client of the admin's REST door."""

from rafiki_tpu_torch.client.client import Client  # noqa: F401
