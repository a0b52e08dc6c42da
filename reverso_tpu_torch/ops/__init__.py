from .attention import (
    attention_ref,
    flash_attention,
    flash_attention_heads,
    flash_attention_heads_ref,
)
from .deformable import ms_deform_attn, ms_deform_attn_ref
from .fused_mlp import fused_mlp, fused_mlp_int8, mlp_int8_ref, mlp_ref
from .norm import l2_normalize
from .rope import apply_rope_2d, rope_2d_tables
from .topk import apply_score_threshold, cosine_topk, cosine_topk_ref
from .pq import pq_decode, pq_encode, pq_topk, train_pq
from .l1 import manhattan_topk, manhattan_topk_host
from .recommend import (
    average_query,
    sum_scores_query,
    best_score_topk,
    context_topk,
    discover_topk,
)
