// The Alg. 2 RegTop-k selection metric for one element:
//
//   Delta = (g_prev - omega * a_prev) / (omega * a)   where s_prev > 0
//         = q                                         elsewhere
//   score = |a|^y * tanh(|1 + Delta| / mu)
//
// op for op as repro.kernels.regtopk_score.score_chain and the port's plain
// version repro_torch.kernels.regtopk_score.score_chain: a zero denominator is
// guarded to 1, the s_prev > 0 select comes after the division, y == 1 skips
// the pow and y == 2 is one multiply (as torch's pow special-cases it). The
// fused path is only equal to the dense fallback bit for bit if this score
// equals the plain torch score, so every file that includes this header is
// compiled without --use_fast_math and with -fmad=false: IEEE division,
// tanhf, and no multiply-add contracted into an FMA. Shared by the fused
// select->encode kernel (fused_encode.cu) and the elementwise score kernel
// (regtopk_score.cu).
#pragma once

__device__ __forceinline__ float score_chain(float a, float a_prev,
                                             float s_prev, float g_prev,
                                             float omega, float mu, float q,
                                             float y) {
  const float denom = omega * a;
  const float safe = denom == 0.0f ? 1.0f : denom;
  const float delta_sent = (g_prev - omega * a_prev) / safe;
  const float delta = s_prev > 0.0f ? delta_sent : q;
  const float reg = tanhf(fabsf(1.0f + delta) / mu);
  float mag = fabsf(a);
  if (y == 2.0f) {
    mag = mag * mag;
  } else if (y != 1.0f) {
    mag = powf(mag, y);
  }
  return mag * reg;
}
