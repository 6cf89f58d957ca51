"""The plain references the benchmark holds the port against: plain
PyTorch, importing nothing of the program (``localization``, ``slam``)."""
