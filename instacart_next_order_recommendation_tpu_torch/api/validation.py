"""Pydantic validation helper mapping errors to HTTP 422 (FastAPI-style)."""

from __future__ import annotations

import json
from typing import Type, TypeVar

from pydantic import BaseModel, ValidationError

from instacart_next_order_recommendation_tpu_torch.api.http import ApiError

T = TypeVar("T", bound=BaseModel)


def validate(model: Type[T], payload) -> T:
    try:
        return model.model_validate(payload)
    except ValidationError as exc:
        raise ApiError(422, json.loads(exc.json()))
