from .greedy import chosen_logprob, greedy_decode, multi_head_greedy_decode

__all__ = ["chosen_logprob", "greedy_decode", "multi_head_greedy_decode"]
