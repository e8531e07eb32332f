from . import html, video  # noqa: F401
