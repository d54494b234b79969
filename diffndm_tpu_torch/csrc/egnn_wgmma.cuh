// Warpgroup matrix multiply (wgmma) for the bf16 edge-chain kernels of
// egnn_edge.cu and their backward (egnn_edge_bwd.cu), sm_90a only: the
// shared-memory matrix descriptors of the 128-byte-swizzled K-major and
// MN-major layouts, the fences, and wgmma.mma_async m64nNk16 bf16 with
// fp32 accumulators, A from registers and B from shared memory for N =
// 128, 192, 256, and both from shared memory for N = 32, 64, 96, 128.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The descriptor of a K-major B tile in the 128-byte swizzle: rows (the N
// index) of 128 bytes, 64 bf16 of k each, whose eight 16-byte groups are
// stored at group ^ (row % 8); the swizzle is taken from the address bits,
// so the tile must start on a 1024-byte boundary.  Start address >> 4 in
// bits 0-13, the leading offset (unused by a swizzled K-major tile) 1 in
// bits 16-29, the stride between groups of eight rows (1024 bytes) >> 4
// in bits 32-45, the layout (1: 128-byte swizzle) in bits 62-63.  A k-step
// of 16 further adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t wgmma_desc_b128(uint32_t smem_address) {
    return (uint64_t)((smem_address & 0x3ffff) >> 4)
           | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32)
           | ((uint64_t)1 << 62);
}

// before a wgmma that reads registers this thread has written (its A
// fragment, or an accumulator written outside a wgmma)
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// until at most N committed groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// ties each accumulator register to this point, so that the compiler
// moves no access of it across a wgmma_wait
template <int NT>
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[NT][4]) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j]) :: "memory");
}

// D (64 x N, fp32) = A (64 x 16, bf16, registers) * B (16 x N, bf16, shared
// memory at desc) + (scale_d ? D : 0), asynchronous until wgmma_wait.  Per
// warp w of the warpgroup, rows 16w..16w+15 in mma.sync.m16n8k16's
// fragment layouts (lane = 4 * g + t): a[0] (g, k 2t..2t+1), a[1] (g+8,
// 2t..2t+1), a[2] (g, 2t+8..2t+9), a[3] (g+8, 2t+8..2t+9), the lower k in
// the low half; d[j] = columns 8j..8j+7: d[j][0] (g, 8j+2t), d[j][1] (g,
// 8j+2t+1), d[j][2] (g+8, 8j+2t), d[j][3] (g+8, 8j+2t+1).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<128>(
        float (&d)[16][4], const uint32_t (&a)[4], uint64_t desc,
        int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<192>(
        float (&d)[24][4], const uint32_t (&a)[4], uint64_t desc,
        int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(
        float (&d)[32][4], const uint32_t (&a)[4], uint64_t desc,
        int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
          "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
          "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
          "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
          "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
          "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
          "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
          "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
          "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
}


// The descriptor of an MN-major tile in the 128-byte swizzle (a 16-bit
// operand whose M or N index is the contiguous one): rows (the K index) of
// 128 bytes, 64 values of M or N each, whose eight 16-byte groups are
// stored at group ^ (row % 8); 8-row groups 1024 bytes apart (the stride
// offset, bits 32-45), 64-wide blocks of M or N `lbo` bytes apart (the
// leading offset, bits 16-29).  As for the K-major tile, the swizzle is
// taken from the address bits: the 8-row groups start on 1024-byte
// boundaries, and a start inside a row (a tile narrower than 64 that does
// not start the row) reads the row from there.
__device__ __forceinline__ uint64_t wgmma_desc_mn128(uint32_t smem_address,
                                                     uint32_t lbo) {
    return (uint64_t)((smem_address & 0x3ffff) >> 4)
           | ((uint64_t)((lbo >> 4) & 0x3fff) << 16)
           | ((uint64_t)(1024 >> 4) << 32)
           | ((uint64_t)1 << 62);
}

// D (64 x N, fp32) [+]= A (64 x 16) * B (16 x N), both bf16 in shared
// memory (descriptors da, db), asynchronous until wgmma_wait.  TA / TB: 0
// K-major, 1 MN-major (the transpose, legal for 16-bit types).  D is the
// N/8 accumulator tiles d[OFF..OFF+N/8-1] in the layout of wgmma_bf16.

template <int OFF, int TA, int TB, int T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[T][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    static_assert(OFF + 4 <= T, "accumulator tiles");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int OFF, int TA, int TB, int T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[T][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    static_assert(OFF + 8 <= T, "accumulator tiles");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
          "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
          "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
          "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]),
          "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]), "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int OFF, int TA, int TB, int T>
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[T][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    static_assert(OFF + 12 <= T, "accumulator tiles");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
          "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
          "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
          "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]),
          "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]), "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3]),
          "+f"(d[OFF + 8][0]), "+f"(d[OFF + 8][1]), "+f"(d[OFF + 8][2]), "+f"(d[OFF + 8][3]),
          "+f"(d[OFF + 9][0]), "+f"(d[OFF + 9][1]), "+f"(d[OFF + 9][2]), "+f"(d[OFF + 9][3]),
          "+f"(d[OFF + 10][0]), "+f"(d[OFF + 10][1]), "+f"(d[OFF + 10][2]), "+f"(d[OFF + 10][3]),
          "+f"(d[OFF + 11][0]), "+f"(d[OFF + 11][1]), "+f"(d[OFF + 11][2]), "+f"(d[OFF + 11][3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int OFF, int TA, int TB, int T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[T][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    static_assert(OFF + 16 <= T, "accumulator tiles");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]),
          "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]),
          "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]),
          "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]),
          "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]),
          "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]),
          "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]),
          "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]), "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3]),
          "+f"(d[OFF + 8][0]), "+f"(d[OFF + 8][1]), "+f"(d[OFF + 8][2]), "+f"(d[OFF + 8][3]),
          "+f"(d[OFF + 9][0]), "+f"(d[OFF + 9][1]), "+f"(d[OFF + 9][2]), "+f"(d[OFF + 9][3]),
          "+f"(d[OFF + 10][0]), "+f"(d[OFF + 10][1]), "+f"(d[OFF + 10][2]), "+f"(d[OFF + 10][3]),
          "+f"(d[OFF + 11][0]), "+f"(d[OFF + 11][1]), "+f"(d[OFF + 11][2]), "+f"(d[OFF + 11][3]),
          "+f"(d[OFF + 12][0]), "+f"(d[OFF + 12][1]), "+f"(d[OFF + 12][2]), "+f"(d[OFF + 12][3]),
          "+f"(d[OFF + 13][0]), "+f"(d[OFF + 13][1]), "+f"(d[OFF + 13][2]), "+f"(d[OFF + 13][3]),
          "+f"(d[OFF + 14][0]), "+f"(d[OFF + 14][1]), "+f"(d[OFF + 14][2]), "+f"(d[OFF + 14][3]),
          "+f"(d[OFF + 15][0]), "+f"(d[OFF + 15][1]), "+f"(d[OFF + 15][2]), "+f"(d[OFF + 15][3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int N, int OFF, int TA, int TB, int T>
__device__ __forceinline__ void wgmma_ss(float (&d)[T][4], uint64_t da,
                                         uint64_t db, int scale_d) {
    if constexpr (N == 32) wgmma_ss_n32<OFF, TA, TB>(d, da, db, scale_d);
    else if constexpr (N == 64) wgmma_ss_n64<OFF, TA, TB>(d, da, db, scale_d);
    else if constexpr (N == 96) wgmma_ss_n96<OFF, TA, TB>(d, da, db, scale_d);
    else wgmma_ss_n128<OFF, TA, TB>(d, da, db, scale_d);
}

}  // namespace
