"""Serving layer of the port: the chunked-decode engine and the staged
serving pipeline."""
