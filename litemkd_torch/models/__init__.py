from .student import (Student, BatchedStudent, Teacher, BatchedTeacher,
                      BACKBONES, CLASSIFIERS, TEACHER_ALIASES, resolve_teacher,
                      make_backbone, make_classifier, init_student_)
from .backbones.resnet import ResNetBackbone, ResNetTrunk, adaptive_max_pool_2d

__all__ = ["Student", "BatchedStudent", "Teacher", "BatchedTeacher",
           "BACKBONES", "CLASSIFIERS", "TEACHER_ALIASES", "resolve_teacher",
           "make_backbone", "make_classifier", "init_student_", "ResNetBackbone", "ResNetTrunk",
           "adaptive_max_pool_2d"]
