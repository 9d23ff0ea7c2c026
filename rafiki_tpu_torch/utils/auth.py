"""Authentication: password hashing and signed API tokens.

Own copy of ``rafiki_tpu/utils/auth.py`` (standard library only): scrypt
password hashes, HMAC-SHA256 tokens over a JSON payload (user id, user
type, expiry), and the per-route user-type check. The formats are the
same, so a token or hash made by either package checks in the other
under the same secret.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import Any, Dict, Optional

from rafiki_tpu_torch import config


class UnauthorizedError(Exception):
    pass


# -- passwords -------------------------------------------------------------


def hash_password(password: str) -> str:
    salt = os.urandom(16)
    digest = hashlib.scrypt(password.encode(), salt=salt, n=2**14, r=8, p=1,
                            dklen=32)
    return base64.b64encode(salt + digest).decode()


def verify_password(password: str, password_hash: str) -> bool:
    try:
        raw = base64.b64decode(password_hash.encode())
        salt, digest = raw[:16], raw[16:]
        check = hashlib.scrypt(password.encode(), salt=salt, n=2**14, r=8,
                               p=1, dklen=32)
        return hmac.compare_digest(digest, check)
    except (ValueError, TypeError):
        return False


# -- tokens ----------------------------------------------------------------


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def generate_token(payload: Dict[str, Any],
                   secret: Optional[str] = None) -> str:
    secret = secret or config.APP_SECRET
    body = dict(payload)
    body.setdefault("exp", time.time() + config.TOKEN_TTL_HOURS * 3600)
    encoded = _b64(json.dumps(body).encode())
    sig = hmac.new(secret.encode(), encoded.encode(), hashlib.sha256).digest()
    return f"{encoded}.{_b64(sig)}"


def decode_token(token: str, secret: Optional[str] = None) -> Dict[str, Any]:
    secret = secret or config.APP_SECRET
    try:
        encoded, sig = token.split(".")
        expect = hmac.new(secret.encode(), encoded.encode(),
                          hashlib.sha256).digest()
        if not hmac.compare_digest(_unb64(sig), expect):
            raise UnauthorizedError("Invalid token signature")
        payload = json.loads(_unb64(encoded))
    except (ValueError, json.JSONDecodeError):
        raise UnauthorizedError("Malformed token")
    if payload.get("exp", 0) < time.time():
        raise UnauthorizedError("Token expired")
    return payload


def auth_check(payload: Dict[str, Any],
               allowed_types: Optional[list] = None) -> None:
    """Raise unless the token's user type is in ``allowed_types``."""
    if (allowed_types is not None
            and payload.get("user_type") not in allowed_types):
        raise UnauthorizedError(
            f"User type {payload.get('user_type')!r} not allowed")
