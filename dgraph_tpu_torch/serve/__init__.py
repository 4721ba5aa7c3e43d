"""Serving surface of the port: mutation application, the HTTP
``/query`` endpoint (JSON or the protobuf ``Response``) and the gRPC
``protos.Dgraph`` / ``protos.Worker`` services."""
