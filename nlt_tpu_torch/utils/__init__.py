from . import config, img, logging, net  # noqa: F401
