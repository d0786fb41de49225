// The element types of the Hopper flash kernels (flash_fwd_sm90.cu,
// flash_bwd_sm90.cu): bf16 and fp16, as one template parameter T.
//
// Elem<T> holds what differs between the two: the tensor map's data type,
// the wgmma instructions (.f32.bf16.bf16 or .f32.f16.f16, both fp32
// accumulators, both taking the same register and shared-memory layouts),
// the packing of two fp32 values into the A operand, and 16-bit loads and
// stores. The bf16 members call hopper_common.cuh's wrappers and use the
// very expressions the kernels used before they took T, so the bf16
// instantiations compile to the code they always did; the fp16 wrappers
// beside them are the same asm with the f16 types.
//
// Rounding to fp16 is round-to-nearest with no saturation (cvt.rn): a
// value past 65504 becomes inf, as `astype(float16)` does in the JAX
// package, so an overflow under a large loss scale reaches the engine's
// overflow check instead of being clipped.
//
// A 16-bit bias is of T (a bf16 bias with bf16 inputs, an fp16 one with
// fp16 inputs); Bias::f32 still marks an fp32 bias, which either type takes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dstt_hopper {

// A tensor map of element type `dt` (2 bytes) over a dense [B, S, H, D]
// tensor, as bhsd_map builds the bf16 one.
inline cudaError_t bhsd_map_of(CUtensorMapDataType dt, CUtensorMap* map, const void* ptr, int B,
                               int S, int H, int D, int rows, int cols, int swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1u, (cuuint32_t)rows, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  const CUtensorMapSwizzle sw = swizzle == kSwizzle128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle == kSwizzle64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, dt, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Two fp32 values as one f16x2 register (lo in the low half), rounded to
// nearest; past 65504: inf.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[64] (+)= A (smem, K-major) * B (smem, K-major): m64n128k16, fp16 in, fp32
// out; acc 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128_f16(float (&d)[64], uint64_t da, uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d[32] (+)= A (smem, K-major) * B (smem, K-major): m64n64k16, fp16 in, fp32
// out; acc 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64_f16(float (&d)[32], uint64_t da, uint64_t db,
                                                  int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[16] (+)= A (registers, 4 x f16x2 a thread) * B (smem, MN-major, read
// transposed): m64n32k16; acc 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n32_f16(float (&d)[16], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}

// d[32] (+)= A (registers, 4 x f16x2 a thread) * B (smem, MN-major, read
// transposed): m64n64k16; acc 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64_f16(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}

// d[64] (+)= A (registers, 4 x f16x2 a thread) * B (smem, MN-major, read
// transposed): m64n128k16; acc 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n128_f16(float (&d)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}

template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  static inline cudaError_t map(CUtensorMap* m, const void* p, int B, int S, int H, int D,
                                int rows, int cols, int swizzle) {
    return bhsd_map(m, p, B, S, H, D, rows, cols, swizzle);
  }
  static __device__ __forceinline__ void ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int acc) {
    wgmma_ss_n128(d, da, db, acc);
  }
  static __device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int acc) {
    wgmma_ss_n64(d, da, db, acc);
  }
  static __device__ __forceinline__ void rs_n32(float (&d)[16], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t db, int acc) {
    wgmma_rs_n32(d, a0, a1, a2, a3, db, acc);
  }
  static __device__ __forceinline__ void rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t db, int acc) {
    wgmma_rs_n64(d, a0, a1, a2, a3, db, acc);
  }
  static __device__ __forceinline__ void rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t db, int acc) {
    wgmma_rs_n128(d, a0, a1, a2, a3, db, acc);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_bf16(lo, hi); }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float lo, float hi) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <> struct Elem<__half> {
  static inline cudaError_t map(CUtensorMap* m, const void* p, int B, int S, int H, int D,
                                int rows, int cols, int swizzle) {
    return bhsd_map_of(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, m, p, B, S, H, D, rows, cols, swizzle);
  }
  static __device__ __forceinline__ void ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int acc) {
    wgmma_ss_n128_f16(d, da, db, acc);
  }
  static __device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int acc) {
    wgmma_ss_n64_f16(d, da, db, acc);
  }
  static __device__ __forceinline__ void rs_n32(float (&d)[16], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t db, int acc) {
    wgmma_rs_n32_f16(d, a0, a1, a2, a3, db, acc);
  }
  static __device__ __forceinline__ void rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t db, int acc) {
    wgmma_rs_n64_f16(d, a0, a1, a2, a3, db, acc);
  }
  static __device__ __forceinline__ void rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t db, int acc) {
    wgmma_rs_n128_f16(d, a0, a1, a2, a3, db, acc);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_f16(lo, hi); }
  static __device__ __forceinline__ void store2(__half* p, float lo, float hi) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 load2(const __half* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
  static __device__ __forceinline__ float load1(const __half* p) { return __half2float(*p); }
};

}  // namespace dstt_hopper

namespace dstt_flash {

__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// bias_at for a 16-bit bias of type T (or an fp32 one): the bf16 case is
// flash_common.cuh's bias_at itself.
template <typename T>
__device__ __forceinline__ float bias_at_t(const Bias& bb, int b, int h, int qrow, int kvrow);
template <>
__device__ __forceinline__ float bias_at_t<__nv_bfloat16>(const Bias& bb, int b, int h, int qrow,
                                                          int kvrow) {
  return bias_at(bb, b, h, qrow, kvrow);
}
template <>
__device__ __forceinline__ float bias_at_t<__half>(const Bias& bb, int b, int h, int qrow,
                                                   int kvrow) {
  const long long i = (long long)b * bb.sb + (long long)h * bb.sh + (long long)qrow * bb.sq +
                      (long long)kvrow * bb.sk;
  return bb.f32 ? __ldg(static_cast<const float*>(bb.ptr) + i)
                : __half2float(static_cast<const __half*>(bb.ptr)[i]);
}

}  // namespace dstt_flash
