// One-token GQA flash-decode over a dense cache or a page pool.
// Replaces src/repro/kernels/decode_attention.py::decode_attention and
// ::decode_attention_paged (see attention_core.cuh for the design).
// A decode block holds 4 query rows: all G heads of one KV head share each
// K/V tile it loads (G = 1, 2 or 4 fit one block; larger G takes more).
#include "attention_core.cuh"

SGDRC_ATTENTION_ENTRY(sgdrc_decode_attention, 4)
