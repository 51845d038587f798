// Kernel B1 with sub-pixel jitter: megakernel.cu compiled with kJitter
// (each new sample's primary ray computed in the kernel), as a library of
// its own beside the unjittered one, so that no unjittered instantiation
// carries the jitter code. mega_cuda loads it for a jittered launch.
#define TPURT_MK_JITTER 1
#include "megakernel.cu"
