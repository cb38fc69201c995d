"""Plain float64 references, one module per configuration, named after it.

Each is written from the model's equations with plain torch operations and
imports nothing of the program under test: no kernel, no plain version of
one, no helper. The harness hands a reference the inputs it made itself
(data, initial free values, noise, request points), never anything the
program derived from them.
"""
