"""LSTM controller (paper §IV-C2): samples architecture decisions via
softmax classifiers in an autoregressive fashion — 64 hidden units, as
in ENAS, trained with Adam at lr 3.5e-4 (paper §V-A6) using REINFORCE
on the Eq. 1 reward.

The port of ``repro.core.mhas.controller``.  Decision sequence (fixed
length): for the trunk and then for each task, one *depth* decision
(0..max_layers) followed by ``max_layers`` *size* decisions (indices
into ``layer_sizes``; sizes beyond the sampled depth are ignored by the
search space but still sampled, keeping the sequence length fixed).

The LSTM cell is written out as the reference's: gates ``i, f, g, o``,
the forget gate's pre-activation offset by +1, and one bias vector
(``torch.nn.LSTMCell`` has two biases and no offset).  The reference's
``lax.scan`` over the decisions is a Python loop over the static kinds.
Samples come from a ``torch.Generator`` (Gumbel-max on its uniform
draws), so they differ from ``jax.random.categorical``'s; the step
distributions and :func:`logprob_of` are the reference's.  Nothing here
copies to the host: the sampled choices stay on the params' device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.mhas.search_space import SearchSpace
from repro_torch.device import DeviceLike, resolve_device

HIDDEN = 64  # paper: LSTM with 64 hidden units
EMBED = 32


@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    num_decisions: int
    depth_choices: int           # max_layers + 1
    size_choices: int
    kinds: Tuple[int, ...]       # 0=depth, 1=size per step

    @classmethod
    def for_space(cls, space: SearchSpace) -> "ControllerSpec":
        return cls(
            num_decisions=space.num_decisions,
            depth_choices=space.max_layers + 1,
            size_choices=space.num_size_choices,
            kinds=tuple(int(k) for k in space.decision_kinds()),
        )

    @property
    def vocab(self) -> int:
        # start token + depth tokens + size tokens (disjoint id ranges)
        return 1 + self.depth_choices + self.size_choices

    def token_id(self, kind, choice):
        """The next step's input token: ``1 + choice`` after a depth
        decision, ``1 + depth_choices + choice`` after a size decision
        (``kind`` an int or a tensor)."""
        return 1 + choice + (kind != 0) * self.depth_choices

    @property
    def max_choices(self) -> int:
        return max(self.depth_choices, self.size_choices)


def init_controller(spec: ControllerSpec, seed: int = 0, device: DeviceLike = None) -> Dict:
    """Parameters from N(0, 0.05^2) (paper), drawn from a generator on
    ``device`` seeded with ``seed``, and a zero bias."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def init(shape):
        return 0.05 * torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)

    return {
        "embed": init((spec.vocab, EMBED)),
        "wx": init((EMBED, 4 * HIDDEN)),
        "wh": init((HIDDEN, 4 * HIDDEN)),
        "b": torch.zeros((4 * HIDDEN,), dtype=torch.float32, device=dev),
        "depth_head": init((HIDDEN, spec.depth_choices)),
        "size_head": init((HIDDEN, spec.size_choices)),
    }


def _lstm_step(params: Dict, h, c, x):
    z = x @ params["wx"] + h @ params["wh"] + params["b"]
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def _step_logits(params: Dict, spec: ControllerSpec, h, kind: int):
    """The kind's head, padded to max_choices with -1e9."""
    head = params["depth_head"] if kind == 0 else params["size_head"]
    logits = h @ head
    return F.pad(logits, (0, spec.max_choices - logits.shape[-1]), value=-1e9)


def _scores(logits, choice):
    """(log-probability of ``choice``, entropy) of one step's softmax."""
    logp = torch.log_softmax(logits, dim=-1).gather(-1, choice.reshape(1))[0]
    probs = torch.softmax(logits, dim=-1)
    entropy = -torch.sum(probs * torch.where(probs > 0, torch.log(probs + 1e-12), 0.0))
    return logp, entropy


def _start(params: Dict):
    dev = params["embed"].device
    return (torch.zeros((HIDDEN,), dtype=torch.float32, device=dev),
            torch.zeros((HIDDEN,), dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))  # start token id 0


def sample_arch(params: Dict, spec: ControllerSpec,
                generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Autoregressively sample one decision sequence, each step from its
    softmax by Gumbel-max on ``generator``'s draws (a generator on the
    params' device).

    Returns (choices (D,) int32 tensor, sum logprob, sum entropy).
    """
    h, c, tok = _start(params)
    choices, logps, ents = [], [], []
    for kind in spec.kinds:
        x = params["embed"].index_select(0, tok.reshape(1))[0]
        h, c = _lstm_step(params, h, c, x)
        logits = _step_logits(params, spec, h, kind)
        u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                       device=logits.device)
        choice = torch.argmax(logits - torch.log(-torch.log(u)))
        logp, ent = _scores(logits, choice)
        choices.append(choice)
        logps.append(logp)
        ents.append(ent)
        tok = spec.token_id(kind, choice)
    return torch.stack(choices).to(torch.int32), torch.stack(logps).sum(), torch.stack(ents).sum()


def logprob_of(params: Dict, spec: ControllerSpec, tokens):
    """Differentiable log-probability (+entropy) of a sampled sequence —
    the REINFORCE score function.  ``tokens``: the (D,) choices, as a
    tensor, numpy array or list."""
    h, c, tok = _start(params)
    tokens = torch.as_tensor(tokens, device=params["embed"].device).to(torch.int64)
    logps, ents = [], []
    for step, kind in enumerate(spec.kinds):
        choice = tokens[step]
        x = params["embed"].index_select(0, tok.reshape(1))[0]
        h, c = _lstm_step(params, h, c, x)
        logp, ent = _scores(_step_logits(params, spec, h, kind), choice)
        logps.append(logp)
        ents.append(ent)
        tok = spec.token_id(kind, choice)
    return torch.stack(logps).sum(), torch.stack(ents).sum()
