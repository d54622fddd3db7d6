"""Gym-compatible shell over the flagship full-game env.

Port of ``balatro_gym_tpu/envs/balatro_env.py``, the reference's
``BalatroEnv`` contract: ``Discrete(60)`` actions, the same Dict
observation keys and numpy dtypes, ``save_state`` / ``load_state``, an
ASCII render, and ``BalatroEnvValidator``'s determinism and action-mask
checks. The shell is one env (a batch of 1) over the engine's ``reset``,
``step`` and ``observe`` (``engine/full_env.py``); it runs on the card
unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from balatro_gym_tpu_torch.core import cards as C
from balatro_gym_tpu_torch.core.constants import Action, Phase
from balatro_gym_tpu_torch.core.device import run_device
from balatro_gym_tpu_torch.engine import full_env as fe
from balatro_gym_tpu_torch.ops import kernel_rng as KR

_OBS_DTYPES = {
    "hand": np.int8,
    "hand_size": np.int8,
    "deck_size": np.int8,
    "selected_cards": np.int64,
    "chips_scored": np.int64,
    "round_chips_scored": np.int32,
    "progress_ratio": np.float32,
    "mult": np.int32,
    "chips_needed": np.int32,
    "money": np.int32,
    "ante": np.int16,
    "round": np.int8,
    "hands_left": np.int8,
    "discards_left": np.int8,
    "joker_count": np.int8,
    "joker_ids": np.int16,
    "joker_slots": np.int8,
    "consumable_count": np.int8,
    "consumables": np.int16,
    "consumable_slots": np.int8,
    "shop_items": np.int16,
    "shop_costs": np.int16,
    "shop_rerolls": np.int16,
    "hand_levels": np.int8,
    "phase": np.int8,
    "action_mask": np.int8,
    "hands_played": np.int32,
    "best_hand_this_ante": np.int32,
    "boss_blind_active": np.int8,
    "boss_blind_type": np.int8,
    "face_down_cards": np.int64,
}


def _copy(st: fe.FullEnvState) -> fe.FullEnvState:
    return fe.FullEnvState(**{f.name: getattr(st, f.name).clone()
                              for f in dataclasses.fields(st)})


class BalatroGymEnv:
    """One env with the reference ``BalatroEnv`` contract. device: where the
    env steps (default: the card; it raises where there is none)."""

    metadata = {"render_modes": ["human"]}

    def __init__(self, *, seed: int = 0, render_mode: str | None = None, device=None):
        self.render_mode = render_mode
        self._seed = seed
        self._st = None
        self.device = run_device((), device)
        try:
            from gymnasium import spaces

            self.action_space = spaces.Discrete(Action.ACTION_SPACE_SIZE)
        except ImportError:  # pragma: no cover
            self.action_space = None

    # ---------------------------- Gym interface ----------------------------

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None:
            self._seed = seed
        self._st = fe.reset(torch.stack(KR.seed_key(self._seed, device=self.device))[None])
        return self._obs(), {}

    def step(self, action: int):
        a = torch.tensor([int(action)], dtype=torch.int32, device=self.device)
        self._st, reward, done = fe.step(self._st, a)
        return self._obs(), float(reward[0]), bool(done[0]), False, {}

    def _obs(self) -> Dict[str, Any]:
        return {k: v[0].cpu().numpy().astype(_OBS_DTYPES[k])
                for k, v in fe.observe(self._st).items()}

    # --------------------------- checkpointing ----------------------------

    def save_state(self):
        """A full checkpoint: a copy of the state (RNG streams, hand levels,
        boss state, everything)."""
        return _copy(self._st)

    def load_state(self, saved) -> None:
        self._st = _copy(saved)

    # ------------------------------- render --------------------------------

    def render(self):
        if self.render_mode != "human":
            return
        st = fe.FullEnvState(**{f.name: getattr(self._st, f.name)[0].cpu()
                                for f in dataclasses.fields(self._st)})
        print("=" * 50)
        print(f"Ante {int(st.ante)} - Round {int(st.round)} - "
              f"Phase: {Phase(int(st.phase)).name}")
        if bool(st.boss_active):
            from balatro_gym_tpu_torch.ops.boss import BOSS_NAMES

            print(f"BOSS BLIND: {BOSS_NAMES[int(st.boss_id)]}")
        print(f"Score: {int(st.round_chips_scored)}/{int(st.chips_needed)}  "
              f"Money: ${int(st.money)}  Hands: {int(st.hands_left)}  "
              f"Discards: {int(st.discards_left)}")
        glyph = {1: "+", 2: "*", 3: "W", 4: "G", 5: "S", 6: "O", 7: "$", 8: "L"}
        out = []
        idx = st.hand_idx.numpy()
        for i in range(min(8, int(st.hand_n))):
            slot = int(idx[i])
            s = C.card_str(int(st.card_rank[slot]), int(st.card_suit[slot]))
            e = glyph.get(int(st.card_enh[slot]), "")
            mark = "[*]" if bool(st.selected[i]) else ""
            out.append(f"{i}:{s}{e}{mark}")
        print("Hand:", " ".join(out))

    def close(self):
        pass


def make_balatro_env(**kwargs) -> BalatroGymEnv:
    return BalatroGymEnv(**kwargs)


class BalatroEnvValidator:
    """Determinism and action-mask validation, as the reference's
    ``BalatroEnvValidator``; ``device`` is the envs' (default: the card)."""

    @staticmethod
    def validate_determinism(seed: int = 42, steps: int = 100, device=None) -> bool:
        e1, e2 = BalatroGymEnv(seed=seed, device=device), BalatroGymEnv(seed=seed, device=device)
        o1, _ = e1.reset()
        o2, _ = e2.reset()
        rng = np.random.default_rng(0)
        for _ in range(steps):
            legal = np.flatnonzero(o1["action_mask"])
            if len(legal) == 0:
                break
            a = int(rng.choice(legal))
            o1, r1, d1, _, _ = e1.step(a)
            o2, r2, d2, _, _ = e2.step(a)
            if r1 != r2 or d1 != d2:
                return False
            for k in o1:
                if not np.array_equal(o1[k], o2[k]):
                    return False
            if d1:
                o1, _ = e1.reset()
                o2, _ = e2.reset()
        return True

    @staticmethod
    def validate_action_masking(seed: int = 7, steps: int = 50, device=None) -> bool:
        """Masked actions must give exactly -1 and leave the state as it
        was; unmasked ones must not end in the invalid-action freeze."""
        env = BalatroGymEnv(seed=seed, device=device)
        obs, _ = env.reset()
        rng = np.random.default_rng(1)
        for _ in range(steps):
            mask = obs["action_mask"].astype(bool)
            illegal = np.flatnonzero(~mask)
            if len(illegal):
                saved = env.save_state()
                _, r, done, _, _ = env.step(int(rng.choice(illegal)))
                if r != -1.0 or done:
                    return False
                env.load_state(saved)
            legal = np.flatnonzero(mask)
            if len(legal) == 0:
                break
            obs, r, done, _, _ = env.step(int(rng.choice(legal)))
            if done:
                obs, _ = env.reset()
        return True
