"""Optional API-key auth.

The port's copy of the JAX package's ``api/auth.py``: disabled unless the
``API_KEY`` env var is set; accepts ``X-API-Key`` or ``Authorization: Bearer
<key>``; 401 on missing/invalid.
"""

from __future__ import annotations

import hmac
import os

from instacart_next_order_recommendation_tpu_torch.api.http import ApiError, Request
from instacart_next_order_recommendation_tpu_torch.constants import ENV_API_KEY


def _extract_api_key(request: Request) -> str | None:
    x_api_key = request.header("x-api-key")
    if x_api_key:
        return x_api_key.strip()
    authorization = request.header("authorization")
    if authorization and authorization.lower().startswith("bearer "):
        return authorization[7:].strip()
    return None


def verify_api_key(request: Request) -> None:
    """Raise 401 when API_KEY is set and the request lacks a valid key."""
    expected = os.getenv(ENV_API_KEY) or None
    if not expected:
        return
    provided = _extract_api_key(request)
    if not provided:
        raise ApiError(
            401,
            "API key required. Provide X-API-Key header or Authorization: Bearer <key>.",
        )
    if not hmac.compare_digest(provided.encode(), expected.encode()):
        raise ApiError(401, "Invalid API key.")
