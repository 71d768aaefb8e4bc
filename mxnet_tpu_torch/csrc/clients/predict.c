/*
 * Inference through the port's predict ABI from C (src/mxtpu.h): a
 * symbol's JSON and the bytes of a .params file, one input of shape
 * N x C x H x W, MXPredCreate on the CPU (dev_type 1) or the card (2),
 * then 3 untimed and `calls` timed rounds of MXPredSetInput +
 * MXPredForward + MXPredGetOutput, then two MXPredForwardAsync tickets
 * in flight whose outputs must equal the synchronous one.
 *
 *   predict SYMBOL.json PARAMS INPUT.f32 PROBS_OUT.f32 DEV_TYPE CALLS
 *           N C H W
 *
 * Prints the create time, the ms of each call and the images/s over
 * them, and PREDICT OK; writes the last call's output (float32).
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "mxtpu.h"

#define WARMUP 3 /* untimed calls: cuDNN's plans, the allocator */

static char *slurp(const char *path, long *size) {
  FILE *f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END);
  *size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char *buf = malloc(*size + 1);
  if (fread(buf, 1, *size, f) != (size_t)*size) {
    fclose(f);
    return NULL;
  }
  buf[*size] = 0;
  fclose(f);
  return buf;
}

static double now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

#define CHECK(x)                                                   \
  if ((x) != 0) {                                                  \
    fprintf(stderr, "%s: %s\n", #x, MXPredGetLastError());         \
    return 3;                                                      \
  }

int main(int argc, char **argv) {
  if (argc != 11) {
    fprintf(stderr, "usage: see the header of predict.c\n");
    return 2;
  }
  long ns, np_, nx;
  char *sym = slurp(argv[1], &ns);
  char *params = slurp(argv[2], &np_);
  float *x = (float *)slurp(argv[3], &nx);
  if (!sym || !params || !x) {
    fprintf(stderr, "cannot read the inputs\n");
    return 2;
  }
  int dev_type = atoi(argv[5]), calls = atoi(argv[6]);
  uint32_t shape[4];
  for (int i = 0; i < 4; ++i) shape[i] = (uint32_t)atoi(argv[7 + i]);
  const char *keys[] = {"data"};
  uint32_t indptr[] = {0, 4};
  void *h = NULL;
  double t0 = now_ms();
  CHECK(MXPredCreate(sym, params, (int)np_, dev_type, 0, 1, keys, indptr,
                     shape, &h));
  printf("create ms %.1f\n", now_ms() - t0);
  uint32_t *oshape, ondim, total = 1;
  CHECK(MXPredGetOutputShape(h, 0, &oshape, &ondim));
  for (uint32_t i = 0; i < ondim; ++i) total *= oshape[i];
  float *out = malloc((size_t)total * 4);
  double wall = 0;
  for (int c = -WARMUP; c < calls; ++c) {
    double t = now_ms();
    CHECK(MXPredSetInput(h, "data", x, (uint32_t)(nx / 4)));
    CHECK(MXPredForward(h));
    CHECK(MXPredGetOutput(h, 0, out, total));
    t = now_ms() - t;
    if (c < 0) {
      printf("warm-up ms %.3f\n", t);
      continue;
    }
    wall += t;
    printf("call %d ms %.3f\n", c, t);
  }
  printf("images/s %.2f over %d calls of %u\n",
         shape[0] * calls / (wall / 1e3), calls, shape[0]);
  int64_t t1, t2;
  float *a = malloc((size_t)total * 4), *b = malloc((size_t)total * 4);
  CHECK(MXPredForwardAsync(h, &t1));
  CHECK(MXPredForwardAsync(h, &t2));
  CHECK(MXPredGetOutputAsync(h, t2, 0, b, total));
  CHECK(MXPredGetOutputAsync(h, t1, 0, a, total));
  if (memcmp(a, out, (size_t)total * 4) || memcmp(b, out, (size_t)total * 4)) {
    fprintf(stderr, "the async outputs differ from the synchronous one\n");
    return 4;
  }
  FILE *f = fopen(argv[4], "wb");
  if (!f || fwrite(out, 4, total, f) != total) return 5;
  fclose(f);
  MXPredFree(h);
  printf("PREDICT OK\n");
  return 0;
}
