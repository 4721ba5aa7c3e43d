"""Password hashing for the password type and checkpwd().

The reference uses bcrypt (types/password.go:29,42).  bcrypt isn't in
this image; we use salted PBKDF2-HMAC-SHA256 from the stdlib — same
contract (one-way hash at mutation time, verify at query time).
"""

from __future__ import annotations

import hashlib
import hmac
import os

_ROUNDS = 10_000
_PREFIX = "pbkdf2$"


def hash_password(plain: str) -> str:
    salt = os.urandom(8)
    dk = hashlib.pbkdf2_hmac("sha256", plain.encode(), salt, _ROUNDS)
    return _PREFIX + salt.hex() + "$" + dk.hex()


def verify_password(plain: str, stored: str) -> bool:
    if not stored.startswith(_PREFIX):
        # unhashed legacy value: constant-time direct compare (bytes —
        # compare_digest rejects non-ASCII str operands)
        return hmac.compare_digest(plain.encode(), stored.encode())
    try:
        salt_hex, dk_hex = stored[len(_PREFIX):].split("$", 1)
        salt = bytes.fromhex(salt_hex)
    except ValueError:
        return False
    dk = hashlib.pbkdf2_hmac("sha256", plain.encode(), salt, _ROUNDS)
    return hmac.compare_digest(dk.hex(), dk_hex)
