"""One module a network, each with ``ops(widths=...)``."""
