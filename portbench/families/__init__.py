"""Model families: one module each (``<family>.py``), named by a
configuration's ``port.family`` and found by name (``harness.family``).
A family builds the port's model configuration, draws the weights from
the seed, and runs the plain reference; adding a family is adding a
module here and its reference under ``reference/``."""
