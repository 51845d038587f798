from tpurt_torch.scene.builder import Material, MeshHandle, SceneBuilder  # noqa: F401
from tpurt_torch.scene.types import MaterialType, Scene, from_arrays  # noqa: F401
