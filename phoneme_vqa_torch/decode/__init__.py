from .beam import beam_decode, expand_to_beams, multi_head_beam_decode
from .greedy import chosen_logprob, greedy_decode, multi_head_greedy_decode
from .pool import pool_greedy_decode
from .sample import filter_logits, sample_decode
from .speculative import draft_from_pair, make_prompt_lookup_draft, speculative_greedy_decode

__all__ = [
    "beam_decode", "chosen_logprob", "draft_from_pair", "expand_to_beams", "filter_logits",
    "greedy_decode", "make_prompt_lookup_draft", "multi_head_beam_decode",
    "multi_head_greedy_decode", "pool_greedy_decode", "sample_decode",
    "speculative_greedy_decode",
]
