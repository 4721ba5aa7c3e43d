"""A throwaway TLS certificate for the port's TLS tests: one self-signed
RSA certificate from the ``openssl`` CLI, valid for ``localhost`` and
``127.0.0.1`` (gRPC checks the target's name against it).  A test that
needs one skips where ``openssl`` is missing, as the reference's TLS
tests do."""

import subprocess

import pytest


def make_cert(directory) -> tuple:
    """(cert path, key path) of a fresh certificate under ``directory``;
    skips the calling test when ``openssl`` cannot make one."""
    cert, key = directory / "cert.pem", directory / "key.pem"
    try:
        r = subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(cert), "-days", "1",
             "-subj", "/CN=localhost",
             "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
            capture_output=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        pytest.skip("openssl unavailable")
    if r.returncode != 0:
        pytest.skip("openssl unavailable")
    return str(cert), str(key)
