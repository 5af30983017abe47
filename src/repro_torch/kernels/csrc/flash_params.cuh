// Launch parameters of K5, shared by the float32 SIMT kernel
// (flash_attention.cu) and the bf16 Hopper kernel (flash_attention_sm90.cu).
#pragma once

#include <cstdint>

struct FlashParams {
  // field order mirrors _FlashParams in flash_attention.py
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // strides in elements over (batch, sequence, head); the last dim is dense
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int32_t b, sq, skv, h, kvh, d;
  int32_t causal;
  int32_t dtype;  // 0: float32, 1: bfloat16
  float scale;
};
