"""Operations and bytes of the program's work, from shapes alone."""

from __future__ import annotations

# the env-step kernel reads its mask slot table once per launch (416 slots
# of 8 bytes) and two 2-byte swap entries per board row
ENV_STEP_SLOT_BYTES = 3328


def rows(players: int) -> int:
    """Rows of a Splendor observation: 56, 71 and 88 at 2, 3 and 4."""
    nobles = {2: 3, 3: 4, 4: 5}[players]
    return 31 + nobles + players + players * nobles + players + 6 * players


def forward_flops(nb_vect: int, width: int, actions: int, players: int) -> int:
    """FLOPs (2 per multiply-add) that one leaf evaluation needs: every
    Dense of the v1 trunk at the rows it is applied to (the first four on
    the 7 feature rows, the rest on one pooled row), then the policy and
    value heads.  The score-difference head, which the search does not
    read, and the elementwise work are not counted."""
    w, C = width, 7
    flat = 2 * (w // 2) + (C - 5) * (w // 2) + C * (w - w // 2)
    macs = C * (nb_vect * w + w * w + (w - 32) * (w - 8) + w * w)
    macs += flat * w + (w - 16) * (w - 8) + 2 * w * w + (w - 16) * (w - 8)
    macs += w * (w + actions) + w * (w + players)
    return 2 * macs


def env_step_bytes(boards: int, players: int, actions: int = 409) -> int:
    """Bytes one launch of the env-step kernel over ``boards`` boards must
    move: each board's state (``rows x 7`` int8) and int64 action read; its
    child state, float32 terminal vector, bool valid mask and int64 seat
    advance written; the slot table and the swap entries read once."""
    r = rows(players)
    per_board = 2 * r * 7 + 8 + 4 * players + actions + 8
    return boards * per_board + ENV_STEP_SLOT_BYTES + 4 * r


def train_step_flops(nb_vect: int, width: int, actions: int,
                     players: int) -> int:
    """FLOPs that one board of a train step needs: the forward through the
    trunk and all three heads (the score-difference head is trained), and
    the backward's two products per Dense (the weight gradient, and the
    input gradient of every Dense but the first)."""
    w = width
    fwd = forward_flops(nb_vect, w, actions, players) \
        + 2 * w * (w + players * 31)
    return 3 * fwd - 2 * 7 * nb_vect * w
