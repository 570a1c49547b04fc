"""Nested delegation — the paper's ``launch()``.

The torch counterpart of ``repro.core.nested``.  A serve function may
itself open a channel round to a second trust: every trustee shard takes
part in the inner round together (the stacked shards run it as one
``channel.delegate`` over the same leading dimension), so no latch is
needed — each state shard has exactly one owner applying its updates.
``launch_serve`` builds such a two-hop serve function.
"""
from __future__ import annotations

from typing import Callable

from . import channel as ch
from .channel import ChannelConfig, Received


def launch_serve(outer_serve_pre: Callable, inner_serve: Callable,
                 outer_serve_post: Callable, inner_trustees: int,
                 inner_cfg: ChannelConfig) -> Callable:
    """A serve function that performs nested delegation.

      outer_serve_pre(outer_state, received)
          -> (outer_state, inner_dst, inner_payload, carry)
      inner_serve: an ordinary serve of the inner trust's state
      outer_serve_post(outer_state, inner_responses, carry, received)
          -> (outer_state, response_rows)

    The returned function is ``serve((outer_state, inner_state),
    received) -> ((outer_state, inner_state), response_rows)``: the outer
    trustee holds the request (``carry``), the inner apply completes in
    its own channel round (``inner_dst`` / ``inner_payload`` are the
    received rows' (D, N) layout), then the response goes back to the
    original client."""

    def serve(state, received: Received):
        outer_state, inner_state = state
        outer_state, inner_dst, inner_payload, carry = outer_serve_pre(
            outer_state, received)
        inner_state, inner_resp, _info = ch.delegate(
            inner_state, inner_dst, inner_payload, inner_serve,
            inner_trustees, inner_cfg)
        outer_state, resp_rows = outer_serve_post(
            outer_state, inner_resp, carry, received)
        return (outer_state, inner_state), resp_rows

    return serve
