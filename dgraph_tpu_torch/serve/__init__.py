"""Serving surface of the port: mutation application and the HTTP
``/query`` endpoint."""
