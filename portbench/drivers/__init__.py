"""One module per kind of traffic, named by a traffic file's ``driver``: a
``Driver(cell, seed, device)`` with ``setup()``, ``window(seconds)``,
``traced()``, ``release()`` and ``readings()``, and ``e2e``, the
end-to-end metrics its window reports, each with its unit."""
