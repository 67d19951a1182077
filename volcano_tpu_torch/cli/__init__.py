"""Command-line helpers of the port (the reference's ``cli/``; only
``util.parse_resource_list`` so far, which cmd/apiserver.py uses)."""
