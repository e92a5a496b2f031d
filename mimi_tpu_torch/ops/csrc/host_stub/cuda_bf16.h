// Host stand-in for the bfloat16 type and its rounding conversion
// (see cuda_runtime.h in this directory).

#pragma once

#include <string.h>

struct __nv_bfloat16 {
  unsigned short x;
};

// round to nearest even, NaN kept quiet
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u;
  memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
