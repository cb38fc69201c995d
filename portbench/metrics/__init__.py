"""One reader per per-layer metric, ``<metric>.py``, found by name
(``spec.metric_readers``); ``_common.py`` holds what they compute."""
