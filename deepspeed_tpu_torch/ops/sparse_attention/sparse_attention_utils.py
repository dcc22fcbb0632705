"""Model-surgery helpers for sparse attention — the port of
``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``:
functional, returning new tensors rather than editing a model in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


class SparseAttentionUtils:
    @staticmethod
    def extend_position_embedding(pos_emb: torch.Tensor,
                                  max_position: int) -> torch.Tensor:
        """Extend a [T0, D] position-embedding table to ``max_position``
        rows by tiling the original table (the reference's scheme of
        repeating the base embeddings)."""
        T0 = pos_emb.shape[0]
        if max_position <= T0:
            return pos_emb[:max_position]
        return pos_emb.repeat(-(-max_position // T0), 1)[:max_position]

    @staticmethod
    def pad_to_block_size(block_size: int,
                          input_ids: Optional[torch.Tensor],
                          attention_mask: Optional[torch.Tensor] = None,
                          token_type_ids: Optional[torch.Tensor] = None,
                          position_ids: Optional[torch.Tensor] = None,
                          inputs_embeds: Optional[torch.Tensor] = None,
                          pad_token_id: int = 0,
                          ) -> Tuple[int, tuple]:
        """Right-pad sequence tensors so seq_len % block_size == 0; padded
        positions get mask 0 so the attention ignores them.  Returns
        (pad_len, (input_ids, attention_mask, token_type_ids,
        position_ids, inputs_embeds)) with None entries passed through."""
        seq_len = (input_ids.shape[-1] if input_ids is not None
                   else inputs_embeds.shape[-2])
        pad_len = (block_size - seq_len % block_size) % block_size
        if pad_len == 0:
            return 0, (input_ids, attention_mask, token_type_ids,
                       position_ids, inputs_embeds)

        def pad_tok(x, value=0):
            return None if x is None else F.pad(x, (0, pad_len), value=value)

        if position_ids is not None:
            # continue the position sequence into the padding
            extra = position_ids[..., -1:] + torch.arange(
                1, pad_len + 1, device=position_ids.device)
            position_ids = torch.cat([position_ids, extra], dim=-1)
        if inputs_embeds is not None:
            inputs_embeds = F.pad(inputs_embeds, (0, 0, 0, pad_len))
        return pad_len, (pad_tok(input_ids, pad_token_id),
                         pad_tok(attention_mask), pad_tok(token_type_ids),
                         position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len: int,
                              sequence_output: torch.Tensor) -> torch.Tensor:
        """Drop the padding added by ``pad_to_block_size``."""
        if pad_len == 0:
            return sequence_output
        return (sequence_output[..., :-pad_len, :]
                if sequence_output.ndim >= 2 else sequence_output[:-pad_len])
