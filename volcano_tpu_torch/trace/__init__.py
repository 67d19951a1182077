"""The placement explainer's device pass (``trace.explain``), imported by
path. The rest of the reference's tracing layer is still to port."""
