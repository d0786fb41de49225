from . import llama  # noqa: F401
